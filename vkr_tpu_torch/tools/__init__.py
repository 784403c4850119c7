"""The port's user entry points, vkr_tpu/tools' counterparts, each run as
`python -m vkr_tpu_torch.tools.<name>` on the card (VKR_PLATFORM=cpu for
the CPU): render (the headless app), parity (the kernel frame against the
oracle frame, PSNR per channel), profile (per-pass times), scene_info
(the glTF loader's log), viewer (the live fly-through in a browser),
showcase (the dolly capture), bench (bench.py's timed 1080p orbit) and
entry (__graft_entry__.py's entry points: the capturable 128x128
frame and the multi-rank dry run).
Importing a tool runs nothing."""

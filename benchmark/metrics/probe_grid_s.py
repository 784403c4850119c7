"""probe_grid_s: seconds of the probe grid's build at start-up (its cube
faces through K1, the octahedral resample, the depth pyramids), timed
alone by the harness between two synchronizes inside the scene load (see
harness/program.py:build). Moves setup_s."""


def read(ctx):
    return getattr(ctx, "probe_grid_s", None)

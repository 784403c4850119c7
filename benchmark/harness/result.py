"""The run's last line and what it must hold: the result's JSON object,
the card's name and power limit, the check that no JAX module was loaded,
and the comparison's numbers beside their limits as the last lines of
standard error and the last key of the result."""

from __future__ import annotations

import json
import math
import subprocess
import sys

# top-level module names the process must not hold once the window has
# closed: JAX and the JAX package the port was made from, compared whole
# (vkr_tpu_torch, the port, begins with vkr_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "vkr_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or what kept it from
    saying."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def device_info(count: int, peak_bytes: int, busy_s=None,
                window_s=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        out["busy_s"] = busy_s
        out["window_s"] = window_s
    return out


def finite(x):
    """JSON has no NaN or infinity: such a reading is written as a string."""
    return x if isinstance(x, int) or math.isfinite(x) else str(x)


def emit(result: dict, checks: dict) -> int:
    """Print the comparison's numbers and limits as the last lines of
    standard error, then the result, with checks as its last key, as the
    last line of standard output. Exits non-zero, printing no result,
    where a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        log(f"ERROR: modules {bad} are loaded in the process that prints "
            "the result (the benchmark runs the PyTorch port alone)")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    line = dict(result)
    line["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    print(json.dumps(line), flush=True)
    return 0

"""The run's last line, the device it names, and the isolation check."""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# Top-level module names that no run may hold: JAX and the JAX package the
# program was ported from. Compared whole, so the program's own package,
# whose name begins with the JAX package's, does not match.
FORBIDDEN = ("jax", "jaxlib", "flax", "lipsync_tpu")

Check = Tuple[str, float, float]  # name, number, limit (correct: number <= limit)


def forbidden_modules(modules: Sequence[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names
                   if m.split(".", 1)[0] in FORBIDDEN})


def device_info(device, count: int, power_limit: Optional[float]) -> Dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device)),
                "power_limit_w": power_limit}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0, "power_limit_w": None}


def checks_correct(checks: List[Check]) -> bool:
    return bool(checks) and all(v == v and v <= lim for _, v, lim in checks)


def emit(correct: bool, attempted: int, failed: int,
         metrics: Dict[str, Tuple[float, str]], device: Dict,
         checks: List[Check], breakdown: Optional[Dict] = None,
         out=None) -> Dict:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    out = out or sys.stdout
    for name, value, limit in checks:
        print(f"check {name} = {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed),
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return line

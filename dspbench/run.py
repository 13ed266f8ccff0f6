"""Run one cell of the benchmark once and print its result line.

    python3 -m dspbench.run --workload vkitti2.drive --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared
beside its limit); the same numbers close standard error.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.

The process first holds glibc's allocator thresholds at a fresh
process's values (``fix_allocator``).  It runs on the card only: without CUDA, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.  It also exits with
code 3, printing no result, if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: glibc's ``mallopt`` parameters, and the values a run holds them at:
#: those glibc gives a fresh process (mmap and trim thresholds of 128 KiB).
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
FRESH_THRESHOLD = 128 << 10


def fix_allocator() -> None:
    """Hold glibc's mmap and trim thresholds at a fresh process's values.
    Left dynamic, glibc raises them to the largest block the process has
    freed, so a run's pace would hang on what the process did before its
    window: ``pack_frame``'s per-frame arrays are then either mapped and
    faulted in anew every frame or reused from the heap (PERF.md §2).
    Held at the start values, every array over 128 KiB is mapped anew
    each time, as in a fresh process."""
    libc = ctypes.CDLL(None)
    for param in (M_MMAP_THRESHOLD, M_TRIM_THRESHOLD):
        if libc.mallopt(param, FRESH_THRESHOLD) != 1:
            raise RuntimeError(f"mallopt({param}, {FRESH_THRESHOLD}) failed")


#: Top-level modules that must never be loaded (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_dsp_map_tpu")


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number from 0 up")
    fix_allocator()
    # Keep a library that looks for JAX or Flax on its own from loading it.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    from dspbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"dspbench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_process=T_PROCESS)
    found = forbidden_loaded()
    if found:
        print(f"dspbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"card: {harness.card_line()}", file=sys.stderr)
    for line in harness.limits_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

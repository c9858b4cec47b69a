"""Smoke run of ttnx on the GPU: every solver family of the scan tier,
compiled for the card at its benchmark sizes, each gated by its oracle.

    python chip_smoke.py                 # one card, all phases
    python chip_smoke.py --multichip 4   # the sharded phases on four cards

The phases are the sections of ``bench.py``. Each prints one JSON line
(compile and run seconds, gate values and limits, matmul precision, peak
device bytes); a gate that fails raises and the script exits non-zero. The
last line is ``{"ok": true, "device": {...}}``. Without a GPU the script
exits non-zero before any phase runs.
"""

import argparse
import json
import os
import subprocess
import sys


def card_line() -> str:
    """Name and power limit of the card, read by ``nvidia-smi`` in a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def single_card_phases(bench):
    phases = [bench.eager_f64,
              lambda: bench.cn_step(16), lambda: bench.cn_step(64),
              bench.batched_als, lambda: bench.batched_als(impl="explicit"),
              bench.dmrg, bench.tdvp1, bench.tdvp2,
              lambda: bench.cross("maxvol"),
              lambda: bench.cross("dmrg", batch=8)]
    for R in (16, 32, 64):
        for B in (1, 512):
            phases.append(lambda r=R, b=B: bench.cg_kernel(r, b))
    return phases


def multichip_phases(bench, n_dev):
    return [lambda: bench.multichip_batched_als(n_dev),
            lambda: bench.multichip_cn_tp(n_dev),
            lambda: bench.multichip_tsqr(n_dev)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multichip", type=int, default=0, metavar="N",
                        help="run only the sharded phases on N cards")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    n_dev = args.multichip or 1
    if len(devices) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench

    bench.enable_compile_cache()
    print(card_line(), flush=True)
    phases = (multichip_phases(bench, n_dev) if args.multichip
              else single_card_phases(bench))
    for phase in phases:
        print(json.dumps(phase()), flush=True)
    print(json.dumps({"ok": True, "device": bench.device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

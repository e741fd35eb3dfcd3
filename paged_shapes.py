"""The paged kernels of a checkout (paged prefill, paged decode) timed on one
GPU at every shape a chip_smoke.py run launched them at, with this tree's
chip_smoke.py timers, so that one call times two commits' kernels alike:

    python3 chip_smoke.py > run.log
    python3 paged_shapes.py --kernels run.log --root _checkout/parent
    python3 paged_shapes.py --kernels run.log --root .

`--kernels` is a file holding a chip_smoke.py run's `kernels` line: the
`launch_shapes` of its paged rows ({"WxMB": launches}, lanes x table blocks
of phase 3's mistral-nemo-12b at blocks of 16) say which shapes are timed
and how often each ran. `time_prefill` / `time_decode` time each shape at
the most history its table holds, so the sum of launches x milliseconds
bounds the kernel's share of that phase's wall from above. `--root` names
the checkout whose src/ holds the kernels (its package is imported before
chip_smoke.py, which then uses it). Prints the card's nvidia-smi name and
power limit and one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def kernels_line(path):
    """The rows of the last `kernels` line in a chip_smoke.py log."""
    rows = None
    with open(path) as fh:
        for line in fh:
            if line.startswith('{"kernels"'):
                rows = json.loads(line)["kernels"]
    if rows is None:
        raise SystemExit(f"paged_shapes: no kernels line in {path}")
    return {r["name"]: r for r in rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", required=True,
                    help="log of a chip_smoke.py run with its kernels line")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose src/ holds the kernels timed")
    args = ap.parse_args(argv)
    rows = kernels_line(args.kernels)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("paged_shapes: no CUDA device\n")
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import repro_torch  # noqa: F401  (the root's package, first)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = cs.nvidia_smi_line()
    cs.build.build_all([cs.paged_prefill.SOURCE, cs.paged_decode.SOURCE])
    cfg = cs.get_config("mistral-nemo-12b")
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 3)
    out = {"root": os.path.abspath(args.root), "device": smi}
    for name, timer in (("paged_prefill", cs.time_prefill),
                        ("paged_decode", cs.time_decode)):
        for codec in ("bf16", "int8"):
            launches = rows[f"{name}[{codec}]"]["launch_shapes"]
            ms = {}
            for k in launches:
                w, mb = (int(x) for x in k.split("x"))
                ms[k] = timer(cfg, gen, w, mb, codec, plain=False)[0]
            out[f"{name}[{codec}]"] = {
                "ms_by_shape": ms,
                "launches_x_ms": sum(n * ms[k] for k, n in launches.items())}
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

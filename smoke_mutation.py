"""Which attention error does chip_smoke.py's phase 13 catch end to end?
Builds the kernels (phase 1), then runs phase 13(b) (llama4-scout, greedy
steps against the plain attention under the kernel run's MoE routes) and
13(a) (mixtral-8x7b, the paged engine against its greedy replay under
the engine's routes) with the ring decode kernel's output (ops
.decode_attention_fwd, B3) scaled by a factor, patched at run time:

    python3 smoke_mutation.py       # 13(b) at x0.9 and x0.97, 13(a) at x0.9

Prints, for each case, whether the phase failed (caught) or passed. Phase
2 holds the kernel itself at the bf16 tolerance; this shows how large an
error the end-to-end checks see on their own. Needs a CUDA device.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = (("13b", 0.9), ("13b", 0.97), ("13a", 0.9))


def main():
    sys.path.insert(0, HERE)
    sys.argv = [os.path.join(HERE, "chip_smoke.py")]
    import torch
    import chip_smoke as C
    from repro_torch.kernels import ops as kops

    phases = {"13a": C.phase_mixtral, "13b": C.phase_scout}
    C.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    orig = kops.decode_attention_fwd
    for tag, scale in CASES:
        kops.decode_attention_fwd = (lambda *a, _s=scale, **k:
                                     orig(*a, **k) * _s)
        try:
            phases[tag]()
            print(f"B3 x{scale}: {tag} passed (not caught)", flush=True)
        except SystemExit:
            print(f"B3 x{scale}: {tag} failed (caught)", flush=True)
        finally:
            kops.decode_attention_fwd = orig
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

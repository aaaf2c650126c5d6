#!/usr/bin/env python3
"""Time the two row-segment designs of the top-k deposit (K2) that were
tried and not kept (``tools/k2_segment_designs.cu``) against the port's K2
(``topk_cr_deposit``), on the card, at the training path's timed shape:
a (3, 1, 352,321,536) ring, two ``topk_ef`` payloads of k = R/16 into slots
[0, 2] (and into [1, 1], where the messages share a slot).

    python3 tools/k2_segment_designs.py      # from the repository root

Each design is checked bitwise against ``topk_cr_deposit_plain`` first,
then timed with CUDA events over 5 calls, in turns (K2, red, delta, ...,
K2), three rounds; the card's name and power limit are printed beside.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cr_reduce.kernel import topk_cr_deposit  # noqa: E402
from repro_torch.kernels.cr_reduce.ref import (  # noqa: E402
    topk_cr_deposit_plain)
from repro_torch.kernels.topk_ef.kernel import topk_ef  # noqa: E402

R = 28 * 2048 * 6144                        # layers/mlp/w_gate
VP, LL = ctypes.c_void_p, ctypes.c_longlong


def build():
    src = ROOT / "tools" / "k2_segment_designs.cu"
    out = _build.BUILD_DIR / "libk2_segment_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.k2_design_launch.argtypes = [VP] * 6 + [LL] * 4 + [ctypes.c_int, VP]
    lib.k2_design_scratch_words.argtypes = [LL] * 3
    lib.k2_design_scratch_words.restype = LL
    return lib


def design(lib, delta):
    def run(acc, vals, idx, slots, w):
        s, m, k = vals.shape
        scratch = torch.empty(lib.k2_design_scratch_words(s, m, R),
                              dtype=torch.int32, device=acc.device)
        rc = lib.k2_design_launch(
            acc.data_ptr(), vals.data_ptr(), idx.data_ptr(), slots.data_ptr(),
            w.data_ptr(), scratch.data_ptr(), s, m, R, k, int(delta),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"CUDA error {rc}"
        return acc
    return run


def ms(fn, iters=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = build()
    designs = {"K2 (kept)": topk_cr_deposit, "red": design(lib, False),
               "delta": design(lib, True)}
    gen = torch.Generator(device=dev).manual_seed(0)
    k = R // 16
    vals, idx = [], []
    for _ in range(2):
        g = torch.randn((1, R), generator=gen, device=dev)
        v, i, _ = topk_ef(g, None, k, out_err=g)
        vals.append(v)
        idx.append(i)
        del g
    vals, idx = torch.stack(vals), torch.stack(idx)
    acc = 0.01 * torch.randn((3, 1, R), generator=gen, device=dev)
    w = torch.tensor([1.0, 0.5], device=dev)
    for slots in ([0, 2], [1, 1]):
        sl = torch.tensor(slots, dtype=torch.int32, device=dev)
        want = topk_cr_deposit_plain(acc.clone(), vals, idx, sl, w)
        for name, fn in designs.items():
            got = fn(acc.clone(), vals, idx, sl, w)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            print(f"slots {slots} {name}: bitwise the plain version {same}")
            assert same
            del got
        del want
        torch.cuda.empty_cache()
        for rnd in range(3):
            times = {name: ms(lambda: fn(acc, vals, idx, sl, w))
                     for name, fn in designs.items()}
            again = ms(lambda: topk_cr_deposit(acc, vals, idx, sl, w))
            print(f"slots {slots} round {rnd}: " + ", ".join(
                f"{name} {t:.4f} ms" for name, t in times.items())
                + f", K2 (kept) again {again:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

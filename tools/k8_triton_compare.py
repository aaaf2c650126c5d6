#!/usr/bin/env python3
"""Time the one-bit EF kernel (K8, ``onebit_ef``, CUDA C++) against its
retired Triton version (kept below, as it ran up to its redesign) and the
launch floor, on the card, at the simulator's shapes, the kernel table's
(32, 4096) and the rows the Triton version looped over.

    python3 tools/k8_triton_compare.py      # from the repository root

Both are first checked against ``onebit_ef_plain`` (the sign map bitwise,
the means and the residual within 1e-6).  Each shape is then timed with
``chip_smoke.device_ms`` (a spin kernel holds the stream until the 20
calls are queued, so the reading is device time), in turns (floor, CUDA,
Triton), three rounds; the least of each and every reading are printed
with the card's name and power limit.  The launch floor is a one-element
in-place ``add_``.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.onebit_ef.kernel import onebit_ef, plan  # noqa: E402
from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain  # noqa: E402

SHAPES = ((8, 32), (16, 512), (8, 100), (256, 256), (32, 4096), (8, 4096),
          (8, 2049), (1, 131072), (1, 1 << 20))

tl = None          # triton.language, bound at the first launch
_KERNEL = None


def _onebit_ef_body(g_ptr, e_ptr, packed_ptr, means_ptr, err_ptr, R, NBYTES,
                    BYTES: "tl.constexpr"):
    """The retired Triton K8: one program a row, two passes over (BYTES,
    8) tiles (sums and count, then the residual and the packed bytes)."""
    row = tl.program_id(0).to(tl.int64)
    g_row = g_ptr + row * R
    e_row = e_ptr + row * R
    byte = tl.arange(0, BYTES)
    bit = tl.arange(0, 8)
    s_pos = tl.zeros((BYTES, 8), dtype=tl.float32)
    s_neg = tl.zeros((BYTES, 8), dtype=tl.float32)
    n_pos = tl.zeros((BYTES, 8), dtype=tl.int32)
    for b0 in range(0, NBYTES, BYTES):
        idx = (b0 + byte)[:, None] * 8 + bit[None, :]
        live = idx < R
        w = tl.load(e_row + idx, mask=live, other=0.0) + \
            tl.load(g_row + idx, mask=live, other=0.0)
        pos = (w >= 0.0) & live
        s_pos += tl.where(pos, w, 0.0)
        s_neg += tl.where(pos, 0.0, w)
        n_pos += pos.to(tl.int32)
    count = tl.sum(tl.sum(n_pos, axis=1), axis=0)
    mean_pos = tl.sum(tl.sum(s_pos, axis=1), axis=0) / \
        tl.maximum(count, 1).to(tl.float32)
    mean_neg = tl.sum(tl.sum(s_neg, axis=1), axis=0) / \
        tl.maximum(R - count, 1).to(tl.float32)
    tl.store(means_ptr + row * 2, mean_pos)
    tl.store(means_ptr + row * 2 + 1, mean_neg)
    out_row = err_ptr + row * R
    packed_row = packed_ptr + row * NBYTES
    for b0 in range(0, NBYTES, BYTES):
        idx = (b0 + byte)[:, None] * 8 + bit[None, :]
        live = idx < R
        w = tl.load(e_row + idx, mask=live, other=0.0) + \
            tl.load(g_row + idx, mask=live, other=0.0)
        pos = (w >= 0.0) & live
        tl.store(out_row + idx, w - tl.where(pos, mean_pos, mean_neg),
                 mask=live)
        bits = tl.sum(pos.to(tl.int32) << bit[None, :], axis=1)
        tl.store(packed_row + b0 + byte, bits.to(tl.uint8),
                 mask=(b0 + byte) < NBYTES)


def triton_onebit_ef(g, e):
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_onebit_ef_body)
    m, r = g.shape
    nbytes = (r + 7) // 8
    new_err = torch.empty_like(g)
    packed = torch.empty((m, nbytes), dtype=torch.uint8, device=g.device)
    means = torch.empty((m, 2), dtype=torch.float32, device=g.device)
    _KERNEL[(m,)](g, e, packed, means, new_err, r, nbytes, BYTES=128,
                  num_warps=4, enable_fp_fusion=False)
    return packed, means, new_err


def agrees(got, want) -> bool:
    return (torch.equal(got[0], want[0])
            and torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
            and torch.allclose(got[2], want[2], rtol=1e-6, atol=1e-6))


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_triton_compare: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {CS.smi_line()}", flush=True)
    x = torch.zeros(1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, r in SHAPES:
        g = torch.randn((m, r), generator=gen, device=dev)
        e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        want = onebit_ef_plain(g, e)
        ok = agrees(onebit_ef(g, e), want), agrees(triton_onebit_ef(g, e),
                                                  want)
        torch.cuda.synchronize()
        if not all(ok):
            print(f"({m}, {r}): disagrees with the plain version (CUDA, "
                  f"Triton) {ok}", flush=True)
            return 1
        reads = {"floor": [], "cuda": [], "triton": []}
        for _ in range(3):
            reads["floor"].append(CS.device_ms(torch, lambda: x.add_(1))[0])
            reads["cuda"].append(CS.device_ms(torch,
                                              lambda: onebit_ef(g, e))[0])
            reads["triton"].append(CS.device_ms(
                torch, lambda: triton_onebit_ef(g, e))[0])
        line = " | ".join(
            f"{k} {min(v):.5f} ms [{', '.join(f'{t:.5f}' for t in v)}]"
            for k, v in reads.items())
        print(f"({m}, {r}) {plan(m, r)}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

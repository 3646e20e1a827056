"""Times the rotate + decompose kernels of go_tfhe_tpu_torch (K1, K4, K6,
K7) and the pipelined step K9 on one CUDA card, two ways: an eager loop of
calls between CUDA events (the way ``chip_smoke.py`` times the other
kernels), and the same calls replayed from a CUDA graph (device time
without the host's launch cost).

    python3 rotdec_times.py [ROOT] [--seed S]

ROOT is the checkout whose package is timed (default: this script's), so
two trees can be compared on one card by running it on each in turns.
Shapes, the main paths': K1 at 128bit_fast B 4096, K4 at uint6_centered B
2048 and uint7_centered B 256, K7 at 128bit_fast B 4096 with bs 3 (the
block rotation) and bs 1 (route (b)), K6 at uint8_centered B 256; K9 at
128bit_fast and 128bit with halves of 2048 and 128bit_fast with halves
of 1024, 3000 and 128, with and without its Y half.  Each result is first
held against the plain version (max |err| 0).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPS = 20


def eager_ms(fn, reps: int) -> float:
    """Mean time of fn() over reps calls between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches captured in one CUDA
    graph and replayed: the kernels back to back, without the host's
    launch cost (a short kernel's eager loop times the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pipe_times(p, gen, cuda_pipe, cuda_t, h: int = 2048) -> dict:
    """K9 at profile p, halves of h: both halves and the X half alone
    (eager and graph); None where the result disagrees with the plain
    version."""
    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device="cuda", generator=gen)

    def amounts(b):
        return torch.randint(0, 2 * p.n + 1, (b,), dtype=torch.int32,
                             device="cuda", generator=gen)

    acc_x, acc_y = words((2, p.n, h)), words((2, p.n, h))
    bsk = words((1, 2 * p.l, 2, p.n))
    if p.key_grid_bits:
        bsk &= ~((1 << p.key_grid_bits) - 1)
    band = cuda_t.pack_bsk_band_t(bsk, cuda_t.band_limb_drop(p))[0]
    args = (cuda_t.rotate_decompose_t_ref(p, acc_x, amounts(h)),
            band.contiguous(), acc_x, acc_y, amounts(h))
    no_y = (torch.empty((2, p.n, 0), dtype=torch.int32, device="cuda"),
            torch.empty((0,), dtype=torch.int32, device="cuda"))
    fn = lambda: cuda_pipe.pipe_step(p, *args)
    got, want = fn(), cuda_pipe.pipe_step_ref(p, *args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        print(f"rotdec_times: pipe_step disagrees with its plain version at "
              f"{p.name}", file=sys.stderr)
        return None
    x_only = lambda: cuda_pipe.pipe_step(p, *args[:3], *no_y)
    return {f"pipe_step {p.name} halves {h}/{h}": {
                "eager_ms": eager_ms(fn, REPS), "graph_ms": graph_ms(fn, REPS)},
            f"pipe_step {p.name} halves {h}/0": {
                "eager_ms": eager_ms(x_only, REPS),
                "graph_ms": graph_ms(x_only, REPS)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rotdec_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from go_tfhe_tpu_torch import params
    from go_tfhe_tpu_torch.ops import (cuda_ext, cuda_ext_t, cuda_pipe,
                                       cuda_rotate, cuda_t)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    fast, u8 = params.P128_FAST, params.UINT8_CENTERED
    # (label, profile, batch, block bits, kernel, plain, row-major layout)
    cases = [("rotate_decompose_t", fast, 4096, 1,
              cuda_t.rotate_decompose_t, cuda_t.rotate_decompose_t_ref, False),
             ("rotate_decompose_ext_t", params.UINT6_CENTERED, 2048, 1,
              cuda_ext_t.rotate_decompose_ext_t,
              cuda_ext_t.rotate_decompose_ext_t_ref, False),
             ("rotate_decompose_ext_t", params.UINT7_CENTERED, 256, 1,
              cuda_ext_t.rotate_decompose_ext_t,
              cuda_ext_t.rotate_decompose_ext_t_ref, False),
             ("rotate_decompose bs=3", fast, 4096, 3,
              cuda_rotate.rotate_decompose, cuda_rotate.rotate_decompose_ref,
              True),
             ("rotate_decompose bs=1", fast, 4096, 1,
              cuda_rotate.rotate_decompose, cuda_rotate.rotate_decompose_ref,
              True),
             ("rotate_decompose_ext", u8, 256, 1,
              cuda_ext.rotate_decompose_ext,
              cuda_ext.rotate_decompose_ext_ref, True)]
    out = {}
    for name, p, b, bs, kernel, plain, row_major in cases:
        words = p.poly_extend_factor * p.n
        acc = torch.randint(-2 ** 31, 2 ** 31,
                            (2, b, words) if row_major else (2, words, b),
                            dtype=torch.int32, device="cuda", generator=gen)
        amounts = torch.randint(0, 2 * words + 1, (bs, b) if bs > 1 else (b,),
                                dtype=torch.int32, device="cuda",
                                generator=gen)
        fn = lambda: kernel(p, acc, amounts)
        err = (fn().int() - plain(p, acc, amounts).int()).abs().max().item()
        if err:
            print(f"rotdec_times: {name} disagrees with its plain version "
                  f"at {p.name} B={b}", file=sys.stderr)
            return 1
        out[f"{name} {p.name} B={b}"] = {
            "eager_ms": eager_ms(fn, REPS), "graph_ms": graph_ms(fn, REPS)}
    for p, h in ((fast, 2048), (params.P128, 2048), (fast, 1024),
                 (fast, 3000), (fast, 128)):
        times = pipe_times(p, gen, cuda_pipe, cuda_t, h)
        if times is None:
            return 1
        out.update(times)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "device": torch.cuda.get_device_name(0),
                      "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure the card's mma.sync m16n8k8 TF32 rate: ``python -m
opensetgaitrecognition_pcaa_tpu_torch.ops.mma_probe``.

Runs ``csrc/mma_probe.cu``: a loop of MMAs alone, and the PointNet
engine's inner step (three passes per product, both operands split in
registers as the engine does, or only A as with weights split ahead of
time), each on 1 and 2 blocks of 8 warps per SM. Prints the TF32 MMA rate
in TFLOP/s (2 x 16 x 8 x 8 operations an MMA) and the rate of f32 products
it gives (a third of it for the three-pass step), with the card's name and
power limit. Needs a CUDA card; writes nothing.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_FLOP_PER_MMA = 2 * 16 * 8 * 8


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    fn = load_library("mma_probe").mma_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.rand(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for which, name, mmas_per_step, steps in ((0, "MMA alone", 16, 20000),
                                              (1, "A and B split + 3 passes", 96, 4000),
                                              (2, "A split + 3 passes", 96, 4000)):
        for per_sm in (1, 2):
            blocks = sms * per_sm
            out = torch.empty(blocks * 256, device="cuda")

            def run():
                err = fn(which, x.data_ptr(), out.data_ptr(), blocks, steps, stream)
                if err != 0:
                    raise RuntimeError(f"mma_probe launch failed: cudaError {err}")

            run()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) / 5 / 1e3
            flops = blocks * 8 * steps * mmas_per_step * _FLOP_PER_MMA
            tf = flops / seconds / 1e12
            print(f"mma_probe: {name}, {per_sm} block(s) of 8 warps per SM: {tf:.1f} TFLOP/s "
                  f"TF32 MMA ({tf / (3 if which else 1):.1f} TFLOP/s of f32 products) [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()

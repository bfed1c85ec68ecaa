"""Where the NMS keep kernel's time goes on the card, and what bounds it.

    python -m tfssd_torch.profile_nms_keep

1. SASS. Disassembles the kernel's library (cuobjdump -sass) and prints
   each innermost loop that divides (MUFU.RCP): the instructions it issues
   on its fast path for each tile op (one warp instruction of IoUs: 32
   pairs, one divide each), leaving out the divide's slow path (a CALL
   that the divide's range check branches over). From the tile ops of one
   instance (the kernel's tiling, at K = 200) and the SM clock nvidia-smi
   reports under load (the median of its samples while the kernel runs),
   it works out the issue-rate floor of the mask phase, tile ops x
   instructions / (4 schedulers x clock) per SM, at R = 160 and 1280: with
   the instances spread evenly over the 132 SMs, and on the busiest SM
   (an instance is one block, so ceil(R / 132) instances).
2. Host time. Host us per call of the wrapper and of its parts, by the
   host clock around back-to-back calls (the median of 7 repeats; 200
   calls where a call launches, else 2000): the input checks, the output
   allocation, the raw handle of the current stream and, beside it,
   torch.cuda.current_stream's Stream object, the ctypes call without a
   launch (R = 0) and with one.

Needs a card and the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import math
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tfssd_torch.ops.kernels import build, nms_keep

SMS = 132
SCHEDULERS = 4
K = 200
TILE = 32
ROWS_PER_STEP = 4  # csrc/nms_keep.cu kRows

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")


def parse_sass(text: str) -> Dict[str, List[Tuple[int, str]]]:
    """{function: [(address, instruction)]} of cuobjdump -sass output."""
    functions: Dict[str, List[Tuple[int, str]]] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            functions[current] = []
            continue
        m = _INSN.search(line)
        if m and current is not None:
            functions[current].append((int(m.group(1), 16),
                                       m.group(2).strip()))
    return functions


def _opcode(insn: str) -> str:
    parts = insn.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def _target(insn: str) -> Optional[int]:
    """Target of a plain BRA (not BRA.DIV), else None."""
    if _opcode(insn) != "BRA":
        return None
    return int(insn.rsplit("0x", 1)[1], 16)


def divide_loops(insns: List[Tuple[int, str]]) -> List[dict]:
    """The innermost loops (backward BRA) that hold a MUFU.RCP, each with
    its address range, the instructions it issues on the fast path (the
    ranges that a forward branch skips and that hold a CALL left out) and
    its number of divides."""
    loops = [(t, a) for a, i in insns
             if (t := _target(i)) is not None and t <= a]
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
                        for lo2, hi2 in loops)]
    # A divide's slow path: the CALL and what the nearest forward branch
    # before it jumps over.
    slow = []
    for c, insn in insns:
        if _opcode(insn).startswith("CALL"):
            slow.append(max((a, t) for a, i in insns
                            if a < c and (t := _target(i)) is not None
                            and t > c))
    out = []
    for lo, hi in inner:
        body = [(a, i) for a, i in insns if lo <= a <= hi]
        divides = sum(_opcode(i) == "MUFU.RCP" for _, i in body)
        if not divides:
            continue
        fast = [i for a, i in body
                if not any(s < a < t for s, t in slow)]
        out.append({"range": (lo, hi), "issued": len(fast),
                    "divides": divides,
                    "per_op": len(fast) / divides})
    return out


def tile_ops(k: int) -> int:
    """Tile ops of one instance, as csrc/nms_keep.cu tiles it: 32 x 32
    tiles on and above the diagonal; a column block of width <= 16 packs
    32 / 2^shift rows into each op; a step is ROWS_PER_STEP ops."""
    nb = -(-k // TILE)
    ops = 0
    for bi in range(nb):
        rows = min(k - bi * TILE, TILE)
        for bc in range(bi, nb):
            width = min(k - bc * TILE, TILE)
            rows_per_op = 1 if width > 16 else 2 if width > 8 else 4
            ops += -(-rows // (ROWS_PER_STEP * rows_per_op)) * ROWS_PER_STEP
    return ops


def issue_floor_us(r: int, ops: int, per_op: float, mhz: float):
    """(even spread, busiest SM) floor in us of r instances' tile ops."""
    hz = mhz * 1e6
    even = r * ops * per_op / (SMS * SCHEDULERS * hz) * 1e6
    busiest = math.ceil(r / SMS) * ops * per_op / (SCHEDULERS * hz) * 1e6
    return even, busiest


def _cuobjdump() -> str:
    nvcc = Path(build.find_nvcc())
    tool = nvcc.with_name("cuobjdump")
    if tool.is_file():
        return str(tool)
    found = shutil.which("cuobjdump")
    if not found:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def sm_clock_under_load(fn, seconds: float = 1.0):
    """(median, card maximum) SM clock in MHz, nvidia-smi sampling every
    50 ms while `fn` is called back to back for `seconds` (an idle card
    clocks down)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    samples = sorted(float(x) for x in out.split() if x.strip())
    if not samples:
        raise RuntimeError("nvidia-smi gave no SM clock samples")
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    return samples[len(samples) // 2], max_mhz


def host_us(fn, calls: int = 200, repeats: int = 7) -> float:
    """Host us per call of `fn`, launches included: the median over
    `repeats` of the host clock around `calls` back-to-back calls, read
    before the device has finished them."""
    readings = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        readings.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return sorted(readings)[repeats // 2]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms_keep needs a CUDA device")
    print(_smi("name,power.limit"))

    rng = np.random.default_rng(0)
    r = 160
    centers = rng.uniform(0.25, 0.75, (r, K, 2))
    sizes = rng.uniform(0.05, 0.4, (r, K, 2))
    boxes = torch.from_numpy(np.concatenate(
        [centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    ).cuda()
    scores = torch.from_numpy(np.sort(rng.uniform(0, 1, (r, K)))[:, ::-1]
                              .astype(np.float32).copy()).cuda()
    thr = (0.45, 0.0)
    mhz, max_mhz = sm_clock_under_load(
        lambda: nms_keep.nms_keep_cuda(boxes, scores, *thr))

    lib = build.build_library("nms_keep").path
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = tile_ops(K)
    per_op = []
    for name, insns in parse_sass(sass).items():
        for loop in divide_loops(insns):
            lo, hi = loop["range"]
            per_op.append(loop["per_op"])
            print(f"sass: {name} loop 0x{lo:x}-0x{hi:x}: {loop['issued']} "
                  f"instructions issued on the fast path for "
                  f"{loop['divides']} tile ops, {loop['per_op']:.2f} per "
                  f"tile op (32 pairs)")
    if not per_op:
        raise RuntimeError("no loop with a divide in the kernel's SASS")
    print(f"sass: {ops} tile ops per instance at K={K}; SM clock {mhz:g} "
          f"MHz under load (the card's maximum {max_mhz:g} MHz)")
    for r_floor in (160, 1280):
        for label, count in (("fewest", min(per_op)),
                             ("most", max(per_op))):
            even, busiest = issue_floor_us(r_floor, ops, count, mhz)
            print(f"floor: R={r_floor} mask phase at {count:.2f} "
                  f"instructions per tile op ({label}): {even:.2f} us "
                  f"spread evenly over {SMS} SMs, {busiest:.2f} us on the "
                  f"busiest SM")

    keep = torch.empty_like(scores, dtype=torch.bool)
    device = boxes.device
    fn = nms_keep._launch_fn()
    ptrs = (boxes.data_ptr(), scores.data_ptr(), keep.data_ptr())
    parts = {
        "wrapper (nms_keep_cuda)":
            lambda: nms_keep.nms_keep_cuda(boxes, scores, *thr),
        "input checks (_check)": lambda: nms_keep._check(boxes, scores),
        "output: torch.empty_like": lambda: torch.empty_like(
            scores, dtype=torch.bool),
        "output: torch.empty": lambda: torch.empty(
            (r, K), dtype=torch.bool, device=device),
        "stream: raw handle": lambda: torch._C._cuda_getCurrentRawStream(
            device.index),
        "stream: torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            device).cuda_stream,
        "ctypes call, R=0 (no launch)": lambda: fn(*ptrs, 0, K, *thr,
                                                   device.index, 0),
        "ctypes call with the launch": lambda: fn(
            *ptrs, r, K, *thr, device.index,
            torch._C._cuda_getCurrentRawStream(device.index)),
    }
    for label, call in parts.items():
        launches = "launch" in label or "wrapper" in label
        us = host_us(call, 200 if launches else 2000)
        print(f"host: {label}: {us:.2f} us per call")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The LRN forward kernel (``sparknet_tpu_torch/csrc/lrn.cu``) against an
earlier checkout's, on one GPU.

Run from the root of a checkout, with a second checkout to compare with
(for example ``git archive <commit>`` unpacked under
``sparknet_tpu_torch/_build/``, which git ignores):

    python3 lrn_ab.py --parent sparknet_tpu_torch/_build/parent

It builds the other checkout's ``csrc/lrn.cu`` with this checkout's nvcc
flags and loads it beside this one's, then:

1. bits: at every case of ``chip_smoke.py``'s kernel phase (the serving
   path's four b256 shapes, GoogLeNet's two, the ragged ones), in float32
   and bfloat16, on ``relu(randn * 50)`` inputs from a seed, counts the
   elements where the two kernels' outputs differ in any bit (the
   comparison is of the stored words), and where this one differs from its
   plain version;
2. times: at the six main-path shapes, in float32 and bfloat16, the two
   kernels in turns (other, this, this, other), each by
   ``chip_smoke.time_ms`` (CUDA events over 10 back-to-back calls, median
   of 25) and by ``chip_smoke.graph_ms`` (the same 10 calls replayed from
   a CUDA graph: device time without the host's launch), beside the bytes
   bound; and the host's wall time a call.

Both checkouts' entry point is ``sparknet_lrn_forward(x, y, batch,
channels, spatial, size, alpha/size, beta, k, is_bf16, stream)``; the other
checkout's source is read first, and one whose entry takes other arguments
is refused.  Prints a JSON summary as its last line, writes every figure
as JSON to ``--json`` if given, and exits non-zero if a bit differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from sparknet_tpu_torch.ops import kernels

SHAPES = cs.LRN_PATH_CASES
# the forward entry's parameters, as this checkout's ops/kernels.py binds them
ENTRY_PARAMS = ("x", "y", "batch", "channels", "spatial", "size",
                "alpha_over_size", "beta", "k", "is_bf16", "stream")


def entry_params(src: str) -> tuple[str, ...]:
    """The parameter names of ``sparknet_lrn_forward`` in a ``lrn.cu``."""
    m = re.search(r"int sparknet_lrn_forward\(([^)]*)\)", src)
    if m is None:
        raise RuntimeError("no sparknet_lrn_forward in the other checkout's lrn.cu")
    return tuple(re.findall(r"(\w+)\s*(?:,|$)", m.group(1).strip()))


def build_other(root: Path) -> ctypes.CDLL:
    """The other checkout's LRN library, built beside this checkout's (the
    two nvcc runs in parallel)."""
    src = root / "sparknet_tpu_torch" / "csrc" / "lrn.cu"
    params = entry_params(src.read_text())
    if params != ENTRY_PARAMS:
        raise RuntimeError(f"{src}: sparknet_lrn_forward{params} is not the entry this "
                           f"script calls, sparknet_lrn_forward{ENTRY_PARAMS}")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = kernels.BUILD_DIR / f"liblrn-other-{digest}.so"
    proc = None
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    log = kernels.build_libraries(["lrn"]).get("lrn")
    if log is not None:
        print(f"build: this checkout's lrn.cu in {time.perf_counter() - t0:.1f} s")
        cs.print_lrn_forward_registers(log)
    if proc is not None and proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout.read()}")
    lib = ctypes.CDLL(str(out))
    lib.sparknet_lrn_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.sparknet_lrn_forward.restype = ctypes.c_int
    return lib


def other_forward(lib, x, size, alpha, beta, k):
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    err = lib.sparknet_lrn_forward(
        x.data_ptr(), y.data_ptr(), b, c, h * w, size, alpha / size, beta, k,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other checkout's LRN forward: CUDA error {err}")
    return y


def words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="root of the checkout to compare with")
    parser.add_argument("--json", type=Path, help="write every figure here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.phase_card()
    other = build_other(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    dev = torch.device("cuda")
    alpha = cs.ALPHA
    result = {"card": card, "bits": [], "times": [], "host": []}
    differ = 0
    cases = [(lab, shp, 5, 0.75, 1.0) for lab, shp in SHAPES] + cs.RAGGED_CASES
    for label, shape, size, beta, k in cases:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got = kernels.lrn_across_channels(xd, size, alpha, beta, k)
            ref = other_forward(other, xd, size, alpha, beta, k)
            plain = kernels.lrn_across_channels_torch(xd.float(), size, alpha, beta,
                                                      k).to(dtype)
            torch.cuda.synchronize()
            n_other = int((words(got) != words(ref)).sum())
            n_plain = int((words(got) != words(plain)).sum())
            differ += n_other
            print(f"bits {label} {list(shape)} size {size} beta {beta} k {k:g} "
                  f"{str(dtype)[6:]}: {n_other} elements differ from the other "
                  f"checkout's kernel, {n_plain} from the plain version")
            result["bits"].append(dict(case=label, shape=list(shape), dtype=str(dtype)[6:],
                                       differ_other=n_other, differ_plain=n_plain))
    # CUDA events over 10 back-to-back calls measure the host's issue rate
    # where a call takes the host longer than the card; a CUDA graph of 10
    # calls replays them with no host work between (chip_smoke.graph_ms)
    timers = (("events", cs.time_ms), ("graph", cs.graph_ms))
    for label, shape in SHAPES:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
            xd = x.to(dtype)
            bound, _ = cs.lrn_bound_ms(shape, 5, itemsize, card)
            for how, timer in timers:
                t = {"other": [], "this": []}
                for who in ("other", "this", "this", "other"):
                    fn = (lambda: other_forward(other, xd, 5, alpha, 0.75, 1.0)) \
                        if who == "other" else \
                        (lambda: kernels.lrn_across_channels(xd, 5, alpha, 0.75, 1.0))
                    t[who].append(timer(fn))
                print(f"time ({how}) {label} {list(shape)} {str(dtype)[6:]}: this "
                      + " / ".join(f"{v:.4f}" for v in t["this"])
                      + f" ms ({100 * bound / min(t['this']):.1f} % of bound), other "
                      + " / ".join(f"{v:.4f}" for v in t["other"])
                      + f" ms ({100 * bound / min(t['other']):.1f} %), bound {bound:.4f} ms "
                      f"[{card}]")
                result["times"].append(dict(case=label, shape=list(shape),
                                            dtype=str(dtype)[6:], timer=how,
                                            this_ms=t["this"], other_ms=t["other"],
                                            bound_ms=bound))
        # the host's side of one call: wall time a call over 200 calls
        # issued without waiting on the card
        for who, fn in (("this", lambda: kernels.lrn_across_channels(x, 5, alpha, 0.75, 1.0)),
                        ("other", lambda: other_forward(other, x, 5, alpha, 0.75, 1.0))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"host {label} f32 {who}: {host_us:.1f} us a call issued")
            result["host"].append(dict(case=label, who=who, us=host_us))
    result["differ_other"] = differ
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps({"differ_other": differ, "cases": len(result["bits"])}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

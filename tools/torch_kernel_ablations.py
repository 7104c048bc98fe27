#!/usr/bin/env python3
"""Time variants of two hand-written CUDA kernels of the port beside the
committed ones, on one CUDA card.

    python3 tools/torch_kernel_ablations.py [--only flash,minplus]

Each variant is the committed source (``src/repro_torch/kernels/csrc/``)
with one change made by text substitution. Every variant is compiled by
its own ``nvcc`` process (all started together) into a library under
``build/ablations/`` and timed by CUDA graph (``chip_smoke.graph_ms``):

- ``flash_attention`` at the LM path's shape (B 2, Hq 32, Hkv 4, S 2,048,
  D 64, bf16, causal; the committed kernel also non-causal), beside
  PyTorch's ``scaled_dot_product_attention``;
- ``minplus_step`` at the router's FULL shape (N 1,024) for B 1, 8, 32.

Each result carries its error against the plain version; a variant marked
``changes_result`` computes another function on purpose (it shows what a
part of the kernel costs). Prints the card's name and power limit, then
one JSON line. Needs nvcc and a card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, graph_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import minplus as mp  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablations")


def sub(old, new):
    """A variant: ``old`` (which must occur) replaced by ``new``."""
    def apply(src):
        if old not in src:
            raise ValueError(f"variant text not found: {old[:60]!r}")
        return src.replace(old, new)
    return apply


def chain(*fns):
    def apply(src):
        for fn in fns:
            src = fn(src)
        return src
    return apply


def min_by_compare(src):
    """fminf replaced by the compare-and-select it was before."""
    src = sub("namespace {\n", "namespace {\n\n__device__ __forceinline__ "
              "float min_cs(float a, float b) { return b < a ? b : a; }\n")(
                  src)
    return re.sub(r"\bfminf\(", "min_cs(", src)


EX2_FMA = """
// 2^x on the FMA pipe: x rounded by the 1.5 * 2^23 trick, a degree-5 fit
// of 2^f on [-0.5, 0.5] (relative error 2^-22), the exponent added in
__device__ __forceinline__ float ex2_fma(float x) {
    x = fmaxf(x, -126.f);
    const float j = x + 12582912.f;
    const float f = x - (j - 12582912.f);
    float p = 1.3266970636323094e-3f;
    p = fmaf(p, f, 9.675459936261177e-3f);
    p = fmaf(p, f, 5.550742521882057e-2f);
    p = fmaf(p, f, 2.4022121727466583e-1f);
    p = fmaf(p, f, 6.931469440460205e-1f);
    p = fmaf(p, f, 1.0000001192092896f);
    return __int_as_float(__float_as_int(p) + (__float_as_int(j) << 23));
}
"""


def soft_exp(cond):
    """ex2 on the FMA pipe for the scores whose (j, e) meet ``cond``."""
    return chain(
        sub("// named barriers 1 and 2:",
            EX2_FMA + "\n// named barriers 1 and 2:"),
        sub("                x = ex2(fmaf(x, c, neg));",
            f"                x = ({cond}) ? ex2_fma(fmaf(x, c, neg))\n"
            "                             : ex2(fmaf(x, c, neg));"))


#: name -> (source, substitution, changes_result)
VARIANTS = {
    "flash": {
        "committed": (None, False),
        "no_lo_product": (sub("            wgmma_rs_n64_tb(acc[p], p_lo[kk],"
                              " db);\n", ""), True),
        "no_turns": (chain(
            sub('asm volatile("bar.sync %0, %1;\\n" :: "r"(1 + g), '
                '"n"(kConsumers)\n                 : "memory");', ""),
            sub('asm volatile("bar.arrive %0, %1;\\n" :: "r"(2 - g), '
                '"n"(kConsumers)\n                 : "memory");', "")),
            False),
        "three_stages": (sub("constexpr int kStages = 2;",
                             "constexpr int kStages = 3;"), False),
        "soft_exp_eighth": (soft_exp("j % 4 == 0 && e == 0"), False),
        "soft_exp_quarter": (soft_exp("j % 2 == 0 && e == 0"), False),
    },
    "minplus": {
        "committed": (None, False),
        "sixteen_warps": (sub("constexpr int kWarps = 32;",
                              "constexpr int kWarps = 16;"), False),
        "one_lane_group": (lambda s: re.sub(r"launch<(\d), 2>",
                                            r"launch<\1, 1>", s), False),
        "compare_select_min": (min_by_compare, False),
    },
}
SOURCES = {"flash": "flash_attention.cu", "minplus": "minplus.cu"}
ENTRY = {"flash": "canal_flash_attention", "minplus": "canal_minplus_step"}


def build_all(kernels):
    """Compile every variant of ``kernels`` in parallel; returns
    {(kernel, variant): ctypes function}."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for kernel in kernels:
        src = open(os.path.join(build.CSRC, SOURCES[kernel])).read()
        for name, (fn, _) in VARIANTS[kernel].items():
            path = os.path.join(OUT, f"{kernel}_{name}.cu")
            with open(path, "w") as f:
                f.write(src if fn is None else fn(src))
            lib = path[:-3] + ".so"
            procs[kernel, name] = (lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                 path, "-o", lib], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kernel, name), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel}/{name}:\n{out}")
        fn = getattr(ctypes.CDLL(lib), ENTRY[kernel])
        fn.argtypes = build._SIGNATURES[ENTRY[kernel]]
        fn.restype = ctypes.c_int
        fns[kernel, name] = fn
    return fns


def flash_rows(fns, device):
    g = torch.Generator(device).manual_seed(5)
    b, hq, hkv, s, d = 2, 32, 4, 2048, 64
    q = torch.randn((b, hq, s, d), generator=g, device=device).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
    out = torch.empty_like(q)
    rows = []
    for causal in (1, 0):
        want = fa.flash_attention_gqa_plain(q, k, v, bool(causal)).float()
        for name, (_, changes) in VARIANTS["flash"].items():
            if not causal and name != "committed":
                continue
            fn = fns["flash", name]

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, hq, hkv, s, s, d, causal, 1,
                         build.stream_ptr(device))
                build.check(err, name)
            call()
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            rows.append({"kernel": "flash_attention", "variant": name,
                         "causal": bool(causal), "ms": graph_ms(call, 20),
                         "max_abs_err": err, "changes_result": changes})
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows.append({"kernel": "scaled_dot_product_attention", "causal": True,
                 "ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                             enable_gqa=True), 20)})
    return rows


def minplus_rows(fns, device):
    rng = np.random.default_rng(0)
    n = 1024
    w = np.where(rng.random((n, n)) < 0.08, rng.uniform(0.01, 3.0, (n, n)),
                 mp.INF).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    w = torch.as_tensor(w, device=device)
    rows = []
    for b in (1, 8, 32):
        d = np.full((b, n), mp.INF, np.float32)
        d[np.arange(b), rng.choice(n, b, replace=False)] = 0.0
        d = mp.minplus_step_plain(torch.as_tensor(d, device=device), w)
        want = mp.minplus_step_plain(d, w)
        out = torch.empty_like(d)
        for name, (_, changes) in VARIANTS["minplus"].items():
            fn = fns["minplus", name]

            def call():
                build.check(fn(d.data_ptr(), w.data_ptr(), out.data_ptr(),
                               b, n, build.stream_ptr(device)), name)
            call()
            torch.cuda.synchronize()
            rows.append({"kernel": "minplus_step", "variant": name, "B": b,
                         "N": n, "ms": graph_ms(call, 50),
                         "equal": bool(torch.equal(out, want)),
                         "changes_result": changes})
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="flash,minplus")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ablations: CUDA is not available",
              file=sys.stderr)
        return 2
    kernels = args.only.split(",")
    device = torch.device("cuda")
    fns = build_all(kernels)
    rows = []
    if "flash" in kernels:
        rows += flash_rows(fns, device)
    if "minplus" in kernels:
        rows += minplus_rows(fns, device)
    print(card_line())
    print(json.dumps({"ablations": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

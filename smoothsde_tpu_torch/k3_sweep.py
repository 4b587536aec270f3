"""Times variants of the CTCRW backward kernels K3a / K3b on one GPU.

    python3 smoothsde_tpu_torch/k3_sweep.py [--parent DIR] [--sass]
        [--variant NAME=GEOMETRY[;NVCC FLAGS] ...]

Compiles csrc/ctcrw_backward.cu of this checkout once per variant, from
a copy with its tile lines (kK3Tile, kK3Steps, kK3MinBlocks, K3Div)
rewritten ("default": the source as it is), and, with --parent, the
ctcrw_backward.cu of another checkout (e.g. the design before this one)
as the variant "parent"; each into its own library under build/k3_sweep/,
with `-Xptxas -v`. Then, at config 5a's shapes (1M steps, d = 2: 62,500
lanes of L = 32; chip_smoke.py's `config5a` data, log tau = log 3, log
nu = 0, mu = 0, sigma_obs = 0.1; the moments and suffix from the port's
own forward kernels), for f32 and f64, each variant's K3a and K3b:
device us per launch (CUDA events over 100 launches, the variants in
turn, forward then backward, twice), the largest difference from the
first variant's output (bitwise 0 when the rounding is unchanged), and
the max abs error against the plain version in f64 over the output's
scale. ptxas's registers, spills and the resident CUDA blocks per SM
they and the shared memory allow are printed beside; with --sass, each
kernel's instruction count by opcode (cuobjdump -sass; static counts).
GEOMETRY is TILE,STEPS,MINB,DIV (lanes per CUDA block, steps per chunk
= threads per lane, CUDA blocks per SM asked of ptxas, BranchFreeDiv or
IeeeDiv), "default" or "parent"; extra nvcc flags (e.g. --use_fast_math)
go after a ";". One JSON line.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
VARIANTS = [
    "default=default", "ieee_div=64,2,8,IeeeDiv",
    "free_regs=64,2,1,BranchFreeDiv", "one_step=128,1,4,BranchFreeDiv",
]
TILE_LINES = ("kK3Tile", "kK3Steps", "kK3MinBlocks", "K3Div")
KERNELS = {"smooth_totals": "pppiii", "score_scan": "ppppdppiii"}
SMEM_SM, REGS_SM, THREADS_SM = 228 * 1024, 65536, 2048  # H100 per SM


def tile_pattern(key):
    if key == "K3Div":
        return rf"(using {key} = )(\w+);"
    return rf"(constexpr int {key} = )(\d+);"


def tile_lines(text):
    """The source's (kK3Tile, kK3Steps, kK3MinBlocks, K3Div)."""
    vals = [re.search(tile_pattern(k), text).group(2) for k in TILE_LINES]
    return tuple(int(v) for v in vals[:3]) + (vals[3],)


def with_tile_lines(text, geo):
    for key, val in zip(TILE_LINES, geo):
        text, n = re.subn(tile_pattern(key), rf"\g<1>{val};", text)
        if n != 1:
            sys.exit(f"k3_sweep: {key} is not on one line of the source")
    return text


def build(name, src, flags, out_root):
    """Start nvcc on src (headers from its own directory, else this
    checkout's csrc/) into out_root/name/libk3.so; returns (library path,
    process)."""
    from smoothsde_tpu_torch.ops import _kernels

    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libk3.so")
    cmd = [_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-Xptxas", "-v",
           "-shared", "-I", os.path.join(HERE, "csrc"), *flags, "-o", so,
           src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def ptxas(text):
    """{kernel_dtype: {registers, spill_stores, spill_loads}}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            cur = None
            for k in KERNELS:
                for code, dt in (("If", "f32"), ("Id", "f64")):
                    if f"{k}_kernel{code}" in sym:
                        cur = f"{k}_{dt}"
                        out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass(so):
    """{kernel_dtype: {opcode: static count}} of a library's K3 kernels."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = None
            for k in KERNELS:
                for code, dt in (("If", "f32"), ("Id", "f64")):
                    if f"{k}_kernel{code}" in m.group(1):
                        cur = out.setdefault(f"{k}_{dt}", {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is not None and m:
            op = m.group(1).split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]), total=sum(
        v.values())) for k, v in out.items()}


def smem_values(tile, steps, kernel):
    """Dynamic shared memory of csrc/ctcrw_backward.cu, in values."""
    items = steps * tile
    if kernel == "smooth_totals":
        return (2 * 11 + 9) * items
    return (2 * 14 + 9 + 1) * items + 5 * (steps + 1) * tile


def blocks_per_sm(regs, threads, smem_bytes):
    per_warp = -(-regs * 32 // 256) * 256  # allocation unit: 256 per warp
    by_regs = REGS_SM // (per_warp * (threads // 32))
    by_smem = SMEM_SM // (smem_bytes + 1024) if smem_bytes else 32
    return min(by_regs, by_smem, THREADS_SM // threads, 32)


def inputs(torch, dtype):
    """(stack, moments, suffix, h) at config 5a's shapes."""
    from chip_smoke import config5a

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

    dev = torch.device("cuda")
    data = config5a()
    obs = np.column_stack([data["y1"], data["y2"]])
    n = len(obs)
    dat = prepare_ctcrw_data(obs, data["time"], data["ID"], dtype=dtype,
                             device=dev)
    par = torch.tensor([0.0, 0.0, np.log(3.0), 0.0], dtype=dtype,
                       device=dev).expand(n, 4).contiguous()
    p = cf.plan(2, n)
    stack, bd = cf.par_stack_from_data(par, dat.yd, dat.dtv, dat.resetf,
                                       dat.validf, p)
    h = torch.tensor([0.01], dtype=dtype, device=dev)
    tot = cf.filter_totals(stack, bd, h, 1.0, 10.0)
    pre = cf.block_prefix(tot, 2, "filter", False)
    mom, _ = cf.filter_scan(stack, bd, pre, h, 1.0, 10.0)
    suffix = cf.block_prefix(cf.smooth_totals(stack, mom), 2, "smooth", True)
    return stack, mom, suffix, h


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout whose ctcrw_backward.cu is "
                    "timed as the variant 'parent'")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=GEOMETRY[;FLAGS] (replaces the list)")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import ctypes

    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or os.curdir) != HERE]
    import torch

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        sys.exit("k3_sweep: no CUDA device")
    src = os.path.join(HERE, "csrc", "ctcrw_backward.cu")
    text = open(src).read()
    specs = args.variant or VARIANTS
    if args.parent:
        specs = ["parent=parent"] + specs
    variants, flags, jobs = {}, {}, {}
    out_root = os.path.join(ROOT, "build", "k3_sweep")
    for spec in specs:
        name, rest = spec.split("=", 1)
        geo, _, extra = rest.partition(";")
        flags[name] = extra.split()
        path = src
        if geo == "parent":
            path = os.path.join(os.path.abspath(args.parent),
                                "smoothsde_tpu_torch", "csrc",
                                "ctcrw_backward.cu")
            variants[name] = None
        elif geo == "default":
            variants[name] = tile_lines(text)
        else:
            t, st, mb, div = geo.split(",")
            variants[name] = (int(t), int(st), int(mb), div)
            os.makedirs(os.path.join(out_root, name), exist_ok=True)
            path = os.path.join(out_root, name, "ctcrw_backward.cu")
            with open(path, "w") as f:
                f.write(with_tile_lines(text, variants[name]))
        jobs[name] = build(name, path, flags[name], out_root)
    res = {"card": torch.cuda.get_device_name(0), "variants": {}}
    libs = {}
    for name, (so, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"k3_sweep: nvcc failed for {name}:\n{o}\n{e}")
        lib = ctypes.CDLL(so)
        for k, sig in KERNELS.items():
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"ssde_ctcrw_{k}_{dt}")
                fn.argtypes = [_kernels._CTYPES[c] for c in sig] + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = lib
        geo = variants[name]
        info = {"geometry": None if geo is None else dict(zip(
            ("tile", "steps", "min_blocks", "division"), geo)),
                "nvcc_flags": flags[name], "ptxas": ptxas(o + e)}
        if args.sass:
            info["sass"] = sass(so)
        if geo is not None:
            t, s, _, _ = geo
            for key, pt in info["ptxas"].items():
                kern, dt = key.rsplit("_", 1)
                nbytes = smem_values(t, s, kern) * (4 if dt == "f32" else 8)
                pt["smem_bytes"] = nbytes
                pt["blocks_per_sm"] = blocks_per_sm(pt["registers"], t * s,
                                                    nbytes)
        else:
            for pt in info["ptxas"].values():
                pt["blocks_per_sm"] = blocks_per_sm(pt["registers"], 128, 0)
        res["variants"][name] = info

    names = list(libs)
    for dtype, dt in ((torch.float32, "f32"), (torch.float64, "f64")):
        stack, mom, suffix, h = inputs(torch, dtype)
        L, rows, lanes = stack.shape
        stream = torch.cuda.current_stream().cuda_stream
        outs = {}

        def call(name, kern):
            fn = getattr(libs[name], f"ssde_ctcrw_{kern}_{dt}")
            if kern == "smooth_totals":
                o = (torch.empty((9, lanes), dtype=dtype, device="cuda"),)
                a = (stack.data_ptr(), mom.data_ptr(), o[0].data_ptr(), rows,
                     L, lanes, stream)
            else:
                o = (torch.empty((L, 4, lanes), dtype=dtype, device="cuda"),
                     torch.empty((lanes,), dtype=dtype, device="cuda"))
                a = (stack.data_ptr(), mom.data_ptr(), suffix.data_ptr(),
                     h.data_ptr(), 1.0, o[0].data_ptr(), o[1].data_ptr(),
                     rows, L, lanes, stream)
            return o, a, fn

        with torch.no_grad():
            s64, m64, x64, h64 = (t.double() for t in (stack, mom, suffix, h))
            ref = {"smooth_totals": (cf.smooth_totals_plain(s64, m64),),
                   "score_scan": cf.score_scan_plain(s64, m64, x64, h64, 1.0)}
        times = {(n, k): [] for n in names for k in KERNELS}
        for order in (names, names[::-1]):
            for name in order:
                for kern in KERNELS:
                    o, a, fn = call(name, kern)
                    for _ in range(5):
                        err = fn(*a)
                        if err:
                            sys.exit(f"k3_sweep: {name} {kern} {dt}: "
                                     f"CUDA error {err}")
                    torch.cuda.synchronize()
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(100):
                        fn(*a)
                    t1.record()
                    torch.cuda.synchronize()
                    times[(name, kern)].append(t0.elapsed_time(t1) * 10.0)
                    outs[(name, kern)] = o
        for name in names:
            for kern in KERNELS:
                got = torch.cat([x.reshape(-1) for x in outs[(name, kern)]])
                first = torch.cat([x.reshape(-1)
                                   for x in outs[(names[0], kern)]])
                want = torch.cat([x.reshape(-1) for x in ref[kern]])
                scale = max(1.0, float(want.abs().max()))
                res["variants"][name][f"{kern}_{dt}"] = {
                    "us": times[(name, kern)],
                    "finite": bool(torch.isfinite(got).all()),
                    "max_diff_vs_first": float((got - first).abs().max()),
                    "n_diff_vs_first": int((got != first).sum()),
                    "max_err_vs_plain_f64_over_scale":
                        float((got.double() - want).abs().max()) / scale,
                }
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

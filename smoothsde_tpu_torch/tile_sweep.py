"""Times variants of the CTCRW forward kernels K1a / K1b
(csrc/ctcrw_filter.cu, family k1) or backward kernels K3a / K3b
(csrc/ctcrw_backward.cu, family k3) on one GPU.

    python3 smoothsde_tpu_torch/tile_sweep.py --family k1|k3 [--parent DIR]
        [--sass] [--variant NAME=GEOMETRY[;NVCC FLAGS] ...]

Compiles the family's source of this checkout once per variant, from a
copy with its tile lines rewritten ("default": the source as it is), and,
with --parent, the same source of another checkout (e.g. the design
before this one) as the variant "parent" (any checkout: GEOMETRY
"@DIR"); each into its own library under build/tile_sweep/<family>/,
with `-Xptxas -v`. Then, at config 5a's shapes (1M steps, d = 2: 62,500
lanes of L = 32; chip_smoke.py's `config5a` data, log tau = log 3,
log nu = 0, mu = 0, sigma_obs = 0.1; the prefix, moments and suffix from
the port's own kernels), for f32 and f64, each variant's two kernels:
device us per launch (CUDA events over 100 launches, the variants in
turn, forward then backward, twice), the count of output values that
differ from the first variant's (the parent with --parent) and the
largest difference (0 and 0 when the rounding is unchanged), and the max
abs error against the plain version in f64 over the output's scale.
ptxas's registers, spills and the resident CUDA blocks per SM they and
the shared memory allow are printed beside; with --sass, each kernel's
instruction count by opcode (cuobjdump -sass; static counts).

GEOMETRY is the values of the family's tile lines, comma-separated:
  k1: THREADS,MINB,DIV (lanes = threads per CUDA block, CUDA blocks per
      SM asked of ptxas, BranchFreeDiv or IeeeDiv);
  k3: TILE,STEPS,MINB,DIV (lanes per CUDA block, steps per chunk =
      threads per lane, MINB and DIV as for k1);
or "default" or "@DIR"; extra nvcc flags (e.g. --use_fast_math) go after
a ";". One JSON line.
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
P0_POS, P0_VEL = 1.0, 10.0
FAMILIES = {
    "k1": {"source": "ctcrw_filter.cu",
           "lines": ("kK1Threads", "kK1MinBlocks", "K1Div"),
           "kernels": ("filter_totals", "filter_scan"),
           "variants": ["default=default", "ieee_div=128,4,IeeeDiv",
                        "free_regs=128,1,BranchFreeDiv",
                        "threads64=64,8,BranchFreeDiv",
                        "threads32=32,16,BranchFreeDiv"]},
    "k3": {"source": "ctcrw_backward.cu",
           "lines": ("kK3Tile", "kK3Steps", "kK3MinBlocks", "K3Div"),
           "kernels": ("smooth_totals", "score_scan"),
           "variants": ["default=default", "ieee_div=64,2,8,IeeeDiv",
                        "free_regs=64,2,1,BranchFreeDiv",
                        "one_step=128,1,4,BranchFreeDiv"]},
}
# each kernel's inputs (the plain version's arguments) and output shapes
ARGS = {
    "filter_totals": ("stack", "bd", "h", "p0_pos", "p0_vel"),
    "filter_scan": ("stack", "bd", "prefix", "h", "p0_pos", "p0_vel"),
    "smooth_totals": ("stack", "mom"),
    "score_scan": ("stack", "mom", "suffix", "h", "p0_pos"),
}
OUTS = {
    "filter_totals": lambda L, lanes: [(14, lanes)],
    "filter_scan": lambda L, lanes: [(L, 5, lanes), (lanes,)],
    "smooth_totals": lambda L, lanes: [(9, lanes)],
    "score_scan": lambda L, lanes: [(L, 4, lanes), (lanes,)],
}
SMEM_SM, REGS_SM, THREADS_SM = 228 * 1024, 65536, 2048  # H100 per SM


def tile_pattern(name):
    if name.endswith("Div"):
        return rf"(using {name} = )(\w+);"
    return rf"(constexpr int {name} = )(\d+);"


def tile_lines(text, names):
    """The source's values of the tile lines `names`, or None for a
    source without them."""
    found = [re.search(tile_pattern(k), text) for k in names]
    if not all(found):
        return None
    return tuple(m.group(2) if k.endswith("Div") else int(m.group(2))
                 for k, m in zip(names, found))


def with_tile_lines(text, names, geo):
    for name, val in zip(names, geo):
        text, n = re.subn(tile_pattern(name), rf"\g<1>{val};", text)
        if n != 1:
            sys.exit(f"tile_sweep: {name} is not on one line of the source")
    return text


def build(name, src, flags, out_root):
    """Start nvcc on src (headers from its own directory, else this
    checkout's csrc/) into out_root/name/libsweep.so; returns (library
    path, process)."""
    from smoothsde_tpu_torch.ops import _kernels

    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libsweep.so")
    cmd = [_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-Xptxas", "-v",
           "-shared", "-I", os.path.join(HERE, "csrc"), *flags, "-o", so,
           src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def kernel_of(sym, kernels):
    """'<kernel>_<f32|f64>' of a mangled kernel symbol, or None."""
    for k in kernels:
        for code, dt in (("If", "f32"), ("Id", "f64")):
            if f"{k}_kernel{code}" in sym:
                return f"{k}_{dt}"
    return None


def ptxas(text, kernels):
    """{kernel_dtype: {registers, spill_stores, spill_loads}}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernel_of(m.group(1), kernels)
            if cur is not None:
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


def sass(so, kernels):
    """{kernel_dtype: {opcode: static count}} of a library's kernels."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_of(m.group(1), kernels)
            cur = None if name is None else out.setdefault(name, {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is not None and m:
            op = m.group(1).split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]), total=sum(
        v.values())) for k, v in out.items()}


def launch_shape(family, geo, kernel):
    """(threads per CUDA block, dynamic shared memory in values) of a
    kernel at a geometry; None for a source without tile lines (one
    thread per lane, 128 a CUDA block, no shared memory). The k3 kernels
    hold two buffers of staged rows and the elements per item; the score
    scan also an h term per item and the carry's 5 moments in STEPS + 1
    slots per lane."""
    if geo is None:
        return 128, 0
    if family == "k1":
        return geo[0], 0
    tile, steps = geo[0], geo[1]
    items = steps * tile
    rows = {"smooth_totals": 11, "score_scan": 14}[kernel]
    n = (2 * rows + 9) * items
    if kernel == "score_scan":
        n += items + 5 * (steps + 1) * tile
    return items, n


def blocks_per_sm(regs, threads, smem_bytes):
    per_warp = -(-regs * 32 // 256) * 256  # allocation unit: 256 per warp
    by_regs = REGS_SM // (per_warp * (threads // 32))
    by_smem = SMEM_SM // (smem_bytes + 1024) if smem_bytes else 32
    return min(by_regs, by_smem, THREADS_SM // threads, 32)


def inputs(torch, dtype):
    """Every kernel's inputs at config 5a's shapes: {stack, bd, h, prefix,
    mom, suffix, p0_pos, p0_vel}."""
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
    tot = cf.filter_totals(stack, bd, h, P0_POS, P0_VEL)
    pre = cf.block_prefix(tot, 2, "filter", False)
    mom, _ = cf.filter_scan(stack, bd, pre, h, P0_POS, P0_VEL)
    suffix = cf.block_prefix(cf.smooth_totals(stack, mom), 2, "smooth", True)
    return {"stack": stack, "bd": bd, "h": h, "prefix": pre, "mom": mom,
            "suffix": suffix, "p0_pos": P0_POS, "p0_vel": P0_VEL}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=sorted(FAMILIES), required=True)
    ap.add_argument("--parent", help="checkout whose source is timed as "
                    "the variant 'parent'")
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
        sys.exit("tile_sweep: no CUDA device")
    fam = FAMILIES[args.family]
    names, kernels = fam["lines"], fam["kernels"]
    src = os.path.join(HERE, "csrc", fam["source"])
    text = open(src).read()
    specs = args.variant or fam["variants"]
    if args.parent:
        specs = [f"parent=@{args.parent}"] + specs
    variants, flags, jobs = {}, {}, {}
    out_root = os.path.join(ROOT, "build", "tile_sweep", args.family)
    for spec in specs:
        name, rest = spec.split("=", 1)
        geo, _, extra = rest.partition(";")
        flags[name] = extra.split()
        path = src
        if geo.startswith("@"):
            path = os.path.join(os.path.abspath(geo[1:]),
                                "smoothsde_tpu_torch", "csrc", fam["source"])
            variants[name] = tile_lines(open(path).read(), names)
        elif geo == "default":
            variants[name] = tile_lines(text, names)
        else:
            vals = geo.split(",")
            variants[name] = tuple(v if k.endswith("Div") else int(v)
                                   for k, v in zip(names, vals))
            os.makedirs(os.path.join(out_root, name), exist_ok=True)
            path = os.path.join(out_root, name, fam["source"])
            with open(path, "w") as f:
                f.write(with_tile_lines(text, names, variants[name]))
        jobs[name] = build(name, path, flags[name], out_root)
    res = {"card": torch.cuda.get_device_name(0), "family": args.family,
           "variants": {}}
    libs = {}
    for name, (so, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"tile_sweep: nvcc failed for {name}:\n{o}\n{e}")
        lib = ctypes.CDLL(so)
        for k in kernels:
            sig = _kernels._SIGNATURES[f"ctcrw_{k}"]
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"ssde_ctcrw_{k}_{dt}")
                fn.argtypes = [_kernels._CTYPES[c] for c in sig] + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = lib
        geo = variants[name]
        info = {"geometry": None if geo is None else dict(zip(names, geo)),
                "nvcc_flags": flags[name], "ptxas": ptxas(o + e, kernels)}
        if args.sass:
            info["sass"] = sass(so, kernels)
        for k_dt, pt in info["ptxas"].items():
            kern, dt = k_dt.rsplit("_", 1)
            threads, values = launch_shape(args.family, geo, kern)
            pt["smem_bytes"] = values * (4 if dt == "f32" else 8)
            pt["blocks_per_sm"] = blocks_per_sm(pt["registers"], threads,
                                                pt["smem_bytes"])
        res["variants"][name] = info

    names = list(libs)
    for dtype, dt in ((torch.float32, "f32"), (torch.float64, "f64")):
        x = inputs(torch, dtype)
        L, rows, lanes = x["stack"].shape
        stream = torch.cuda.current_stream().cuda_stream
        outs = {}

        def call(name, kern):
            fn = getattr(libs[name], f"ssde_ctcrw_{kern}_{dt}")
            o = tuple(torch.empty(s, dtype=dtype, device="cuda")
                      for s in OUTS[kern](L, lanes))
            tail = (rows, L, lanes) if args.family == "k3" else (L, lanes)
            a = [v.data_ptr() if torch.is_tensor(v) else v for v in
                 (*(x[n] for n in ARGS[kern]), *o, *tail)]
            return o, a + [stream], fn

        with torch.no_grad():
            x64 = {n: v.double() if torch.is_tensor(v) else v
                   for n, v in x.items()}
            ref = {}
            for kern in kernels:
                r = getattr(cf, f"{kern}_plain")(*(x64[n]
                                                   for n in ARGS[kern]))
                ref[kern] = r if isinstance(r, tuple) else (r,)
        times = {(n, k): [] for n in names for k in kernels}
        for order in (names, names[::-1]):
            for name in order:
                for kern in kernels:
                    o, a, fn = call(name, kern)
                    for _ in range(5):
                        err = fn(*a)
                        if err:
                            sys.exit(f"tile_sweep: {name} {kern} {dt}: "
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
            for kern in kernels:
                got = torch.cat([v.reshape(-1) for v in outs[(name, kern)]])
                first = torch.cat([v.reshape(-1)
                                   for v in outs[(names[0], kern)]])
                want = torch.cat([v.reshape(-1) for v in ref[kern]])
                scale = max(1.0, float(want.abs().max()))
                res["variants"][name][f"{kern}_{dt}"] = {
                    "us": times[(name, kern)],
                    "finite": bool(torch.isfinite(got).all()),
                    "max_diff_vs_first": float((got - first).abs().max()),
                    "n_diff_vs_first": int((got != first).sum()),
                    "n_values": got.numel(),
                    "max_err_vs_plain_f64_over_scale":
                        float((got.double() - want).abs().max()) / scale,
                }
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

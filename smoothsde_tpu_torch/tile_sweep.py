"""Times variants of a family of the port's kernels on one GPU: the CTCRW
forward kernels K1a / K1b (csrc/ctcrw_filter.cu, family k1), the CTCRW
backward kernels K3a / K3b (csrc/ctcrw_backward.cu, family k3), the
scalar-state kernels D1a, D1b, D3a and D3b (csrc/diag_filter.cu and
csrc/diag_backward.cu, family diag), or the run design of the cross-block
prefix K2 for the square-root kinds `sqrt2` / `sqrt1`
(csrc/block_prefix.cu, family k2).

    python3 smoothsde_tpu_torch/tile_sweep.py --family k1|k3|diag|k2
        [--parent DIR] [--sass] [--variant NAME=GEOMETRY[;NVCC FLAGS] ...]

Compiles the family's sources of this checkout once per variant, from
copies with their tile lines rewritten ("default": the sources as they
are), and, with --parent, the same sources of another checkout (e.g. the
parent commit, unpacked with `git archive`) as the variant "parent" (any
checkout: GEOMETRY "@DIR"); each variant into its own library under
build/tile_sweep/<family>/, with `-Xptxas -v`. Then, for f32 and f64, at
the family's shapes, each variant's kernels: device us per launch (CUDA
events over 100 launches cycling through copies of the inputs that hold
256 MB, so that no launch finds them in the L2; the variants in turn,
the kernels in order, twice: a same-call A/B against the parent; each
timed loop queued behind a device sleep, so no launch waits on the host), the
count of output values that differ from the first variant's (the parent
with --parent) and the largest difference (0 and 0 when the rounding is
unchanged), and the max abs error against the plain version in f64 over
the output's scale. For D1b (family diag) also the time of a D1b launch
right after the same variant's D1a over the same stack, as in the
forward chain, where D1b finds in the L2 what D1a read ("us_after_d1a"),
and right after a D1a over another copy ("us_after_d1a_other"; CUDA
events around each D1b launch).
ptxas's registers, spills and the resident CUDA blocks per SM they and
the shared memory allow are printed beside; with --sass, each kernel's
instruction count by opcode (cuobjdump -sass; static counts).

Shapes (the inputs of each kernel's plain version; prefixes, moments and
suffixes from the port's own kernels):
  k1, k3: config 5a (1M steps, d = 2: 62,500 lanes of L = 32;
      chip_smoke.py's `config5a` data, log tau = log 3, log nu = 0,
      mu = 0, sigma_obs = 0.1);
  diag: the OU_SSM fit's (phase 3b: chip_smoke.py's `ou_ssm_1m`, d = 2,
      62,500 lanes) and the BM_SSM fit's (phase 3c: `bm_ssm_1m`, d = 1,
      31,250 lanes), each at its simulation truth, sigma_obs = 0.1;
  k2: the square-root totals of config 5a (`sqrt2`) and of 3b's OU_SSM
      (`sqrt1`) at their truths, sigma_obs = 0.1 (the plain phase-1 scan
      of chip_smoke.py's `slice_elements`; NB = 31,250, d = 2), forward.

GEOMETRY is the values of the family's tile lines, comma-separated:
  k1: THREADS,MINB,DIV (lanes = threads per CUDA block, CUDA blocks per
      SM asked of ptxas, BranchFreeDiv or IeeeDiv);
  k3: TILE,STEPS,MINB,DIV (lanes per CUDA block, steps per chunk =
      threads per lane, MINB and DIV as for k1);
  diag: S,LANES,S3,LANES3 (D1a and D1b: segments = threads per lane,
      lanes per CUDA block; then D3a's);
  k2: THREADS,RUN (threads per CUDA block, blocks per thread; a checkout
      without these lines, e.g. the parent of the run design, is timed
      with the reduce / carry / rescan design's tile of 256 and its
      scratch);
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
# per family: its sources, each with the names of its tile lines in the
# order of GEOMETRY (none: the source builds as it is), its kernels
# (entry points of ops/_kernels.py, each with its source) and the default
# variants
FAMILIES = {
    "k1": {"sources": {"ctcrw_filter.cu": ("kK1Threads", "kK1MinBlocks",
                                           "K1Div")},
           "kernels": {"ctcrw_filter_totals": "ctcrw_filter.cu",
                       "ctcrw_filter_scan": "ctcrw_filter.cu"},
           "variants": ["default=default", "ieee_div=128,4,IeeeDiv",
                        "free_regs=128,1,BranchFreeDiv",
                        "threads64=64,8,BranchFreeDiv",
                        "threads32=32,16,BranchFreeDiv"]},
    "k3": {"sources": {"ctcrw_backward.cu": ("kK3Tile", "kK3Steps",
                                             "kK3MinBlocks", "K3Div")},
           "kernels": {"ctcrw_smooth_totals": "ctcrw_backward.cu",
                       "ctcrw_score_scan": "ctcrw_backward.cu"},
           "variants": ["default=default", "ieee_div=64,2,8,IeeeDiv",
                        "free_regs=64,2,1,BranchFreeDiv",
                        "one_step=128,1,4,BranchFreeDiv"]},
    "diag": {"sources": {
                 "diag_filter.cu": ("kD1Segs", "kD1Lanes"),
                 "diag_backward.cu": ("kD3aSegs", "kD3aLanes")},
             "kernels": {"diag_filter_totals": "diag_filter.cu",
                         "diag_filter_scan": "diag_filter.cu",
                         "diag_smooth_totals": "diag_backward.cu",
                         "diag_score_scan": "diag_backward.cu"},
             "variants": ["default=default", "walk=1,128,1,128",
                          "segs2=2,32,2,32", "segs8=8,32,8,32",
                          "lanes64=4,64,4,64", "segs2_64=2,64,2,64",
                          "segs8_64=8,64,8,64"]},
    "k2": {"sources": {"block_prefix.cu": ("kRunThreads", "kRun")},
           "kernels": {"block_prefix_sqrt2": "block_prefix.cu",
                       "block_prefix_sqrt1": "block_prefix.cu"},
           "variants": ["default=default", "run2=128,2", "run8=128,8",
                        "threads64=64,4", "threads256_run2=256,2",
                        "threads64_run2=64,2"]},
}
# K2's element type of each k2 entry point, and its components
K2_ELEM = {"block_prefix_sqrt2": ("Sqrt14", 14),
           "block_prefix_sqrt1": ("Sqrt5", 5)}
# each kernel's inputs (the plain version's arguments) and output shapes
ARGS = {
    "ctcrw_filter_totals": ("stack", "bd", "h", "p0_pos", "p0_vel"),
    "ctcrw_filter_scan": ("stack", "bd", "prefix", "h", "p0_pos", "p0_vel"),
    "ctcrw_smooth_totals": ("stack", "mom"),
    "ctcrw_score_scan": ("stack", "mom", "suffix", "h", "p0_pos"),
    "diag_filter_totals": ("fwd", "h", "p0"),
    "diag_filter_scan": ("fwd", "prefix", "h", "p0"),
    "diag_smooth_totals": ("bwd", "mom"),
    "diag_score_scan": ("bwd", "mom", "suffix", "h", "p0"),
    "block_prefix_sqrt2": ("sqrt2",),
    "block_prefix_sqrt1": ("sqrt1",),
}
OUTS = {
    "ctcrw_filter_totals": lambda L, lanes: [(14, lanes)],
    "ctcrw_filter_scan": lambda L, lanes: [(L, 5, lanes), (lanes,)],
    "ctcrw_smooth_totals": lambda L, lanes: [(9, lanes)],
    "ctcrw_score_scan": lambda L, lanes: [(L, 4, lanes), (lanes,)],
    "diag_filter_totals": lambda L, lanes: [(5, lanes)],
    "diag_filter_scan": lambda L, lanes: [(L, 2, lanes), (lanes,)],
    "diag_smooth_totals": lambda L, lanes: [(3, lanes)],
    "diag_score_scan": lambda L, lanes: [(L, 4, lanes), (lanes,)],
    "block_prefix_sqrt2": lambda L, lanes: [(14, lanes)],
    "block_prefix_sqrt1": lambda L, lanes: [(5, lanes)],
}
SMEM_SM, REGS_SM, THREADS_SM = 228 * 1024, 65536, 2048  # H100 per SM
# each kernel's inputs are cloned until the copies hold this many bytes,
# and the timed launches cycle through them: every launch reads its
# inputs from device memory, not from the 50 MB L2 the last one filled
COLD_BYTES = 256 * 2**20
# a timed loop starts behind a ~25 ms device sleep, so that the host has
# queued every launch before the first runs and no timed kernel waits on
# the host's launch calls
HOLD_CYCLES = 50_000_000


def tile_pattern(name):
    if name.endswith("Div"):
        return rf"(using {name} = )(\w+);"
    return rf"(constexpr int {name} = )(\d+);"


def tile_value(name, text):
    return text if name.endswith("Div") else int(text)


def tile_lines(text, names):
    """The values of the tile lines `names` in a source's text, or None
    for a source without them."""
    found = [re.search(tile_pattern(name), text) for name in names]
    if not all(found):
        return None
    return tuple(tile_value(name, m.group(2))
                 for name, m in zip(names, found))


def with_tile_lines(text, names, geo):
    for name, val in zip(names, geo):
        text, n = re.subn(tile_pattern(name), rf"\g<1>{val};", text)
        if n != 1:
            sys.exit(f"tile_sweep: {name} is not on one line of the source")
    return text


def build(name, srcs, flags, out_root):
    """Start nvcc on the sources srcs (headers from each one's own
    directory, else this checkout's csrc/) into out_root/name/libsweep.so;
    returns (library path, process)."""
    from smoothsde_tpu_torch.ops import _kernels

    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libsweep.so")
    cmd = [_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-Xptxas", "-v",
           "-shared", "-I", os.path.join(HERE, "csrc"), *flags, "-o", so,
           *srcs]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def kernel_of(sym, kernels):
    """'<kernel>_<f32|f64>' of a mangled kernel symbol, or None (each
    entry point's CUDA kernel is its name, less "ctcrw_", + "_kernel");
    for K2, whose entry point launches several CUDA kernels templated on
    the element type, '<entry point>/<CUDA kernel>_<f32|f64>'."""
    for k in kernels:
        if k in K2_ELEM:
            m = re.search(rf"\d(block_prefix_\w+?_kernel)I([fd])NS_\d+"
                          rf"{K2_ELEM[k][0]}I", sym)
            if m:
                return f"{k}/{m.group(1)}_" + (
                    "f32" if m.group(2) == "f" else "f64")
            continue
        fn = k.removeprefix("ctcrw_")
        for code, dt in (("f", "f32"), ("d", "f64")):
            if re.search(rf"\d{fn}_kernelI{code}", sym):
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


def launch_shape(family, geo, kernel, scratch):
    """(threads per CUDA block, shared memory in values) of a kernel at a
    geometry; None for a source without tile lines (one thread per lane,
    128 a CUDA block, no shared memory). The k3 kernels hold two buffers
    of staged rows and the elements per item; the score scan also an h
    term per item and the carry's 5 moments in STEPS + 1 slots per lane.
    D1a and D3a hold their threads' 5- and 3-comp totals, D1b their llk
    partials (a D1b without the segment scratch, `scratch` false, walks
    one thread per lane); D3b walks one thread per lane. K2's run design
    holds its tile of E::N components (one pad slot every 32); the
    reduce / carry / rescan design (a checkout without the run lines)
    256 threads and E::N * 8 values."""
    if family == "k2":
        n = K2_ELEM[kernel][1]
        if geo is None:
            return 256, 8 * n
        tile = geo[0] * geo[1]
        return geo[0], n * (tile + tile // 32)
    if family == "diag":
        values = {"diag_filter_totals": 5, "diag_smooth_totals": 3,
                  "diag_filter_scan": int(scratch)}.get(kernel, 0)
        if geo is None or not values:
            return 128, 0
        return geo[0] * geo[1], values * geo[0] * geo[1]
    if geo is None:
        return 128, 0
    if family == "k1":
        return geo[0], 0
    tile, steps = geo[0], geo[1]
    items = steps * tile
    rows = {"ctcrw_smooth_totals": 11, "ctcrw_score_scan": 14}[kernel]
    n = (2 * rows + 9) * items
    if kernel == "ctcrw_score_scan":
        n += items + 5 * (steps + 1) * tile
    return items, n


def blocks_per_sm(regs, threads, smem_bytes):
    per_warp = -(-regs * 32 // 256) * 256  # allocation unit: 256 per warp
    by_regs = REGS_SM // (per_warp * (threads // 32))
    by_smem = SMEM_SM // (smem_bytes + 1024) if smem_bytes else 32
    return min(by_regs, by_smem, THREADS_SM // threads, 32)


def ctcrw_inputs(torch, dtype):
    """Every CTCRW kernel's inputs at config 5a's shapes: {stack, bd, h,
    prefix, mom, suffix, p0_pos, p0_vel}."""
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


def diag_inputs(torch, dtype, typ):
    """Every scalar-state kernel's inputs at the OU_SSM (phase 3b) or
    BM_SSM (phase 3c) fit's shapes, at the simulation's truth: {fwd, bwd,
    h, prefix, mom, suffix, p0}."""
    from chip_smoke import bm_ssm_1m, ou_ssm_1m

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df

    dev = torch.device("cuda")
    if typ == "OU_SSM":
        data = ou_ssm_1m()
        obs = np.column_stack([data["y1"], data["y2"]])
        theta = [1.0, -0.5, np.log(2.0), 0.0]  # mu, log tau, log kappa
    else:
        data = bm_ssm_1m()
        obs = data["y"][:, None]
        theta = [0.05, np.log(0.3)]  # mu, log sigma
    n, d = obs.shape
    dat = df.prepare_diag_data(typ, obs, data["time"], data["ID"],
                               dtype=dtype, device=dev)
    par = torch.tensor(theta, dtype=dtype, device=dev).expand(
        n, len(theta)).contiguous()
    sysd = df.diag_system(typ, par, None, None, None, 0.1, data=dat)
    p = cf.plan(d, n)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd, bwd = df.forward_stack(*rows), df.backward_stack(*rows)
    h = sysd.h.reshape(1).contiguous()
    seg = df.segment_scratch(fwd)
    pre = cf.block_prefix(df.diag_filter_totals(fwd, h, df.P0, seg), d,
                          "diag_filter", False)
    mom, _ = df.diag_filter_scan(fwd, pre, seg, h, df.P0)
    suffix = cf.block_prefix(df.diag_smooth_totals(bwd, mom), d,
                             "diag_smooth", True)
    return {"fwd": fwd, "bwd": bwd, "h": h, "prefix": pre, "mom": mom,
            "suffix": suffix, "p0": df.P0}


def k2_inputs(torch, dtype):
    """The square-root totals K2 `sqrt2` / `sqrt1` take at config 5a and
    3b's OU_SSM, at their truths: {sqrt2, sqrt1} ((C, 62,500), the plain
    phase-1 scan's last step, computed in f64)."""
    from chip_smoke import config5a, elem_stack, ou_ssm_1m, slice_elements

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import scan_utils as su

    dev = torch.device("cuda")
    out = {}
    with torch.no_grad():
        for typ, kind, data, theta in (
                ("CTCRW", "sqrt2", config5a(), [0.0, 0.0, np.log(3.0), 0.0]),
                ("OU_SSM", "sqrt1", ou_ssm_1m(),
                 [1.0, -0.5, np.log(2.0), 0.0])):
            obs = np.column_stack([data["y1"], data["y2"]])
            n = len(obs)
            par = torch.tensor(theta, dtype=torch.float64,
                               device=dev).expand(n, 4).contiguous()
            el = slice_elements(torch, typ, par, 0.1, obs, data["time"],
                                data["ID"])[kind]
            st = elem_stack(torch, kind, el, cf.plan(2, n))
            out[kind] = su.pallas_phase1_scan_plain(
                st, kind)[-1].to(dtype).contiguous()
    return out


def k2_cols(geo, NB):
    """Columns per dim of K2's scratch at a k2 geometry (None: the
    reduce / carry / rescan design's tile of 256)."""
    if geo is None:
        return -(-NB // 256)
    return -(-NB // (geo[0] * geo[1])) * (geo[0] + 1)


def shapes(family):
    """[(label, inputs(torch, dtype))] of the family."""
    if family == "k2":
        return [("config5a_3b", k2_inputs)]
    if family == "diag":
        return [("ou_ssm_3b", lambda t, dt: diag_inputs(t, dt, "OU_SSM")),
                ("bm_ssm_3c", lambda t, dt: diag_inputs(t, dt, "BM_SSM"))]
    return [("config5a", ctcrw_inputs)]


def plain(kern):
    """The plain PyTorch version of entry point `kern`."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df

    if kern in K2_ELEM:
        kind = kern.removeprefix("block_prefix_")
        return lambda tot: cf.block_prefix_plain(tot, 2, kind, False)
    if kern.startswith("diag_"):
        return getattr(df, f"{kern}_plain")
    return getattr(cf, f"{kern.removeprefix('ctcrw_')}_plain")


def signatures(root):
    """ops/_kernels.py's _SIGNATURES of the checkout at root."""
    import importlib.util

    path = os.path.join(root, "smoothsde_tpu_torch", "ops", "_kernels.py")
    spec = importlib.util.spec_from_file_location(
        f"_sweep_kernels_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=sorted(FAMILIES), required=True)
    ap.add_argument("--parent", help="checkout whose sources are timed as "
                    "the variant 'parent'")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=GEOMETRY[;FLAGS] (replaces the list)")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import ctypes

    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or os.curdir) != HERE]
    import torch

    from smoothsde_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        sys.exit("tile_sweep: no CUDA device")
    fam = FAMILIES[args.family]
    sources, kernels = fam["sources"], fam["kernels"]
    texts = {f: open(os.path.join(HERE, "csrc", f)).read() for f in sources}
    specs = args.variant or fam["variants"]
    if args.parent:
        specs = [f"parent=@{args.parent}"] + specs
    variants, flags, jobs, sigs, segs = {}, {}, {}, {}, {}
    out_root = os.path.join(ROOT, "build", "tile_sweep", args.family)
    for spec in specs:
        name, rest = spec.split("=", 1)
        geo, _, extra = rest.partition(";")
        flags[name] = extra.split()
        # {source: its tile values, or None}, and the files nvcc builds
        paths = {f: os.path.join(HERE, "csrc", f) for f in sources}
        sigs[name] = _kernels._SIGNATURES
        if geo.startswith("@"):
            paths = {f: os.path.join(os.path.abspath(geo[1:]),
                                     "smoothsde_tpu_torch", "csrc", f)
                     for f in sources}
            sigs[name] = signatures(os.path.abspath(geo[1:]))
            variants[name] = {f: tile_lines(open(paths[f]).read(), names)
                              for f, names in sources.items()}
        elif geo == "default":
            variants[name] = {f: tile_lines(texts[f], names)
                              for f, names in sources.items()}
        else:
            vals = iter(geo.split(","))  # the sources' tile lines in order
            os.makedirs(os.path.join(out_root, name), exist_ok=True)
            variants[name] = {}
            for f, names in sources.items():
                variants[name][f] = tuple(tile_value(k, next(vals))
                                          for k in names)
                paths[f] = os.path.join(out_root, name, f)
                with open(paths[f], "w") as out:
                    out.write(with_tile_lines(texts[f], names,
                                              variants[name][f]))
        jobs[name] = build(name, list(paths.values()), flags[name],
                           out_root)
    res = {"card": torch.cuda.get_device_name(0), "family": args.family,
           "variants": {}}
    libs = {}
    for name, (so, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"tile_sweep: nvcc failed for {name}:\n{o}\n{e}")
        lib = ctypes.CDLL(so)
        for k in kernels:
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"ssde_{k}_{dt}")
                fn.argtypes = [_kernels._CTYPES[c]
                               for c in sigs[name][k]] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = lib
        # D1b's segments per lane by working type, as the variant's build
        # reports them, where its D1a and D1b take the segment scratch (the
        # C signatures of this tree); None for a checkout without it
        segs[name] = None
        if ("diag_filter_scan" in kernels and sigs[name]["diag_filter_scan"]
                == _kernels._SIGNATURES["diag_filter_scan"]):
            segs[name] = {}
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"ssde_diag_filter_segs_{dt}")
                fn.argtypes, fn.restype = [], ctypes.c_int
                segs[name][dt] = fn()
        geo = variants[name]
        info = {"geometry": {f: None if g is None else dict(
                    zip(sources[f], g)) for f, g in geo.items()},
                "nvcc_flags": flags[name], "ptxas": ptxas(o + e, kernels)}
        if args.sass:
            info["sass"] = sass(so, kernels)
        for k_dt, pt in info["ptxas"].items():
            kern, dt = k_dt.rsplit("_", 1)
            kern = kern.split("/")[0]
            threads, values = launch_shape(args.family,
                                           geo[kernels[kern]], kern,
                                           segs[name] is not None)
            pt["smem_bytes"] = values * (4 if dt == "f32" else 8)
            pt["blocks_per_sm"] = blocks_per_sm(pt["registers"], threads,
                                                pt["smem_bytes"])
        res["variants"][name] = info

    for label, make_inputs in shapes(args.family):
        for dtype, dt in ((torch.float32, "f32"), (torch.float64, "f64")):
            x = make_inputs(torch, dtype)
            timed(torch, args.family, libs, segs, kernels, x, label, dt,
                  dtype, res, variants)
    print(json.dumps(res), flush=True)


def timed(torch, family, libs, segs, kernels, x, label, dt, dtype, res,
          variants):
    """Times every variant's kernels on the inputs x and records, per
    variant, "<kernel>_<label>_<dt>": us per launch (two rounds), the
    differences from the first variant and the error against the f64
    plain version; for D1b also the two paired times of the module
    docstring (two rounds each)."""
    names = list(libs)
    if family == "k2":
        L = lanes = None
    else:
        stack = x["stack" if family != "diag" else "fwd"]
        L, _, lanes = stack.shape
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}
    copies = {}
    for kern in kernels:
        ins = [x[n] for n in ARGS[kern]]
        nbytes = sum(v.numel() * v.element_size() for v in ins
                     if torch.is_tensor(v))
        copies[kern] = [ins] + [
            [v.clone() if torch.is_tensor(v) else v for v in ins]
            for _ in range(-(-COLD_BYTES // nbytes) - 1)]

    def entry(name, kern):
        return getattr(libs[name], f"ssde_{kern}_{dt}")

    def args(name, kern, ins):
        """(outputs, C arguments, C arguments of this variant's D1a over
        the same stack: D1b only) of kernel kern of variant `name` on the
        inputs `ins` of its plain version. With the segment scratch, D1a
        also writes it and D1b reads the one that D1a wrote. D1b's
        outputs end with that D1a's, which they keep alive. K2 (family
        k2): totals, out, scratch, d, NB, scratch columns, forward."""
        if family == "k2":
            tot = ins[0]
            C, n = tot.shape
            cols = k2_cols(variants[name]["block_prefix.cu"], n // 2)
            o = [torch.empty_like(tot),
                 torch.empty((C, 2 * cols), dtype=dtype, device="cuda")]
            return o, [tot.data_ptr(), o[0].data_ptr(), o[1].data_ptr(), 2,
                       n // 2, cols, 0, stream], None
        o = [torch.empty(s, dtype=dtype, device="cuda")
             for s in OUTS[kern](L, lanes)]
        vals, pre, d1a_out = list(ins), None, []
        tail = (stack.shape[1], L, lanes) if family == "k3" else (L, lanes)
        if kern == "diag_filter_scan":
            d1a_out, pre, _ = args(name, "diag_filter_totals",
                                   [ins[0], x["h"], x["p0"]])
            if segs[name]:
                vals.insert(2, d1a_out[-1])
        if kern == "diag_filter_totals" and segs[name]:
            o.append(torch.empty((segs[name][dt] - 1, 5, lanes), dtype=dtype,
                                 device="cuda"))
        a = [v.data_ptr() if torch.is_tensor(v) else v
             for v in (*vals, *o, *tail)] + [stream]
        return o + d1a_out, a, pre

    def launch(name, kern, a):
        err = entry(name, kern)(*a)
        if err:
            sys.exit(f"tile_sweep: {name} {kern} {dt}: CUDA error {err}")

    with torch.no_grad():
        x64 = {n: v.double() if torch.is_tensor(v) else v
               for n, v in x.items()}
        ref = {}
        for kern in kernels:
            r = plain(kern)(*(x64[n] for n in ARGS[kern]))
            ref[kern] = r if isinstance(r, tuple) else (r,)
    times = {(n, k): [] for n in names for k in kernels}
    paired = {(n, key): [] for n in names
              for key in ("us_after_d1a", "us_after_d1a_other")}
    for order in (names, names[::-1]):
        for name in order:
            for kern in kernels:
                fn = entry(name, kern)
                sets = [args(name, kern, ins) for ins in copies[kern]]
                for _, a, pre in sets:
                    if pre is not None:  # D1b's seeds
                        launch(name, "diag_filter_totals", pre)
                    launch(name, kern, a)
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(HOLD_CYCLES)
                t0.record()
                for r in range(100):
                    fn(*sets[r % len(sets)][1])
                t1.record()
                torch.cuda.synchronize()
                times[(name, kern)].append(t0.elapsed_time(t1) * 10.0)
                if kern == "diag_filter_scan":
                    d1a, n = entry(name, "diag_filter_totals"), len(sets)
                    for key, shift in (("us_after_d1a", 0),
                                       ("us_after_d1a_other", n // 2)):
                        ev = [(torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                              for _ in range(100)]
                        torch.cuda._sleep(HOLD_CYCLES)
                        for r in range(100):
                            d1a(*sets[(r + shift) % n][2])
                            ev[r][0].record()
                            fn(*sets[r % n][1])
                            ev[r][1].record()
                        torch.cuda.synchronize()
                        paired[(name, key)].append(
                            sum(a.elapsed_time(b) for a, b in ev) * 10.0)
                # the outputs of the plain version (not the scratch)
                outs[(name, kern)] = sets[0][0][:len(ref[kern])]
                del sets
    for name in names:
        for kern in kernels:
            got = torch.cat([v.reshape(-1) for v in outs[(name, kern)]])
            first = torch.cat([v.reshape(-1)
                               for v in outs[(names[0], kern)]])
            want = torch.cat([v.reshape(-1) for v in ref[kern]])
            scale = max(1.0, float(want.abs().max()))
            e = res["variants"][name][f"{kern}_{label}_{dt}"] = {
                "us": times[(name, kern)],
                "finite": bool(torch.isfinite(got).all()),
                "max_diff_vs_first": float((got - first).abs().max()),
                "n_diff_vs_first": int((got != first).sum()),
                "n_values": got.numel(),
                "max_err_vs_plain_f64_over_scale":
                    float((got.double() - want).abs().max()) / scale,
            }
            if kern == "diag_filter_scan":
                for key in ("us_after_d1a", "us_after_d1a_other"):
                    e[key] = paired[(name, key)]


if __name__ == "__main__":
    main()

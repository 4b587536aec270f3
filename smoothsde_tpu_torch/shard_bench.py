"""Times the time-sharded nllk+grad on the card, per mesh, against the
unsharded route.

    python3 smoothsde_tpu_torch/shard_bench.py [--root DIR] [--cards]

The data are chip_smoke.py's 1M-step config 5a CTCRW (seed 5) and 3b
OU_SSM (seed 8), in f32, at the start point plus 0.01. For the package
under --root (this checkout if not given; another checkout's tree for an
A/B, run as root, ., ., root in one call) it builds each model with its
time axis in chip_smoke.py's SHARDS chunks on cuda:0, and with --cards
also one chunk a card over every visible card, and the unsharded model,
and prints one JSON line with, per model and mesh: the value, the host
wall ms per nllk+grad (median and p90 of 110 calls after 5), the device
busy ms (torch.profiler, 10 calls) and, for the one-card mesh, the
device ms and operations of the stitch alone (chip_smoke.py
`stitch_device_ms`), with the card's name and power limit (nvidia-smi).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--cards", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import _kernels
    from smoothsde_tpu_torch.parallel.batching import make_mesh, shard_sizes

    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit(f"imported chip_smoke from {cs.__file__}")
    _kernels.build()
    _kernels.load()
    meshes = {"one_card": make_mesh(cs.SHARDS, "time", device="cuda:0")}
    if args.cards:
        meshes["cards"] = make_mesh(None, "time")
    meshes["unsharded"] = None
    out = {"root": args.root, "card": cs.card_line(),
           "cards": torch.cuda.device_count(), "shards": cs.SHARDS}
    for tag, kw, elems in (
            ("ctcrw_5a", dict(data=cs.config5a(), type="CTCRW",
                              response=["y1", "y2"], par0=[0, 0, 2, 0.8]),
             ("filter", "smooth")),
            ("ou_ssm_3b", dict(data=cs.ou_ssm_1m(), type="OU_SSM",
                               response=["y1", "y2"],
                               par0=[0.0, 0.0, 1.0, 1.0]),
             ("diag_filter", "diag_smooth"))):
        r = out[tag] = {}
        for name, mesh in meshes.items():
            b = SDE(**kw, device="cuda").setup(mesh=mesh, mesh_axis="time")
            x = b.packer.outer_init() + 0.01

            def fn(b=b, x=x):
                return cs.bundle_value_grad(torch, b, x)

            _, busy, _ = cs.profile_device_ms(fn, 10, torch)
            r[name] = {"value": fn()[0], "wall_ms": cs.wall_ms(fn, 110, 5),
                       "busy_ms": busy}
        ms, ops = cs.stitch_device_ms(
            torch, 2, shard_sizes(len(kw["data"]["ID"]), cs.SHARDS),
            torch.float32, elems)
        r["one_card"].update(stitch_ms=ms, stitch_ops=ops)
    print("SHARD_BENCH " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

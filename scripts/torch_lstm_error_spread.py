"""How far kernel B1 and the plain float32 LSTM lie from float64, per
output, over many random inputs, on the card.

    python scripts/torch_lstm_error_spread.py [--seeds 8] [--shapes 80x128 1x2048] [--dtype bfloat16]

On the flagship checkpoint's LSTM weights (docs/runs/sad_aux_r4_soup10.pkl),
for each shape TxB and seed: xs ~ N(0, 1) [T, B, H], h0, c0 ~ N(0, 0.25)
[L, B, H], as chip_smoke.py draws them. For each output (outs, hT, cT) it
prints the largest |B1 - plain|, |B1 - f64|, |plain - f64| and |f64|, where
f64 is the plain version in float64. At the first shape it also runs B2
(`lstm_seq_diff`) and the plain version under autograd, and reports whether
B2's forward equals B1's and the plain version under autograd equals it
without, bit for bit. One JSON line per (shape, seed), then one summary line
per shape with the largest of each reading over the seeds. Needs a CUDA card.

With --dtype bfloat16 it does the same for B1 and B2's bfloat16 routes and the
plain bfloat16 version, on the bfloat16-rounded inputs and weights, against
two float64 references: "f64", the same function without the roundings of h
and c (chip_smoke.py's rule), and "f64_st", the function the bfloat16 forward
computed (h and c rounded to bfloat16 each step, the roundings passed
straight through in the derivative). At the first shape it also compares
each input's and weight's grad (B2's and the plain version's autograd) with
both references, relative to the reference's largest value.
"""

import argparse
import json
import subprocess

import torch

from hanabi_sad_tpu_torch.ops.lstm_seq import lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain
from hanabi_sad_tpu_torch.tools import loaders

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
NAMES = ("outs", "hT", "cT")


def flat(result):
    outs, (h, c) = result
    return outs, h, c


def f64_straight_through(params, xs, hidden):
    """The float64 LSTM on bfloat16 values that rounds h and c to bfloat16 at
    every step, the rounding passed straight through in the derivative."""
    rnd = lambda t: t + (t.bfloat16().double() - t).detach()
    h, c = [list(t.unbind(0)) for t in hidden]
    outs = []
    for x in xs.unbind(0):
        for layer, p in enumerate(params):
            gates = x @ p["w_ih"] + h[layer] @ p["w_hh"] + p["b"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
            h[layer], c[layer] = rnd(torch.sigmoid(o) * torch.tanh(c_new)), rnd(c_new)
            x = h[layer]
        outs.append(x)
    return torch.stack(outs), (torch.stack(h), torch.stack(c))


def bf16_spread(args, params, card, dev):
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in params]
    L, H = len(params), params[0]["w_hh"].shape[0]
    wnames = [f"{k}{l}" for l in range(L) for k in ("w_ih", "w_hh", "b")]
    for si, shape in enumerate(args.shapes):
        T, B = (int(v) for v in shape.split("x"))
        worst = {}
        for seed in range(args.seeds):
            gen = torch.Generator().manual_seed(seed)
            xs = torch.randn(T, B, H, generator=gen).to(dev).bfloat16()
            h0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev).bfloat16()
            c0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev).bfloat16()
            cot = [torch.randn(T, B, H, generator=gen).to(dev).bfloat16(),
                   torch.randn(L, B, H, generator=gen).to(dev).bfloat16(),
                   torch.randn(L, B, H, generator=gen).to(dev).bfloat16()]

            def run(fn, dtype, grads):
                ps = [{k: v.to(dtype).clone().requires_grad_(grads) for k, v in p.items()} for p in pb]
                ts = [t.to(dtype).clone().requires_grad_(grads) for t in (xs, h0, c0)]
                with torch.set_grad_enabled(grads):
                    ys = flat(fn(ps, ts[0], (ts[1], ts[2])))
                if not grads:
                    return ys, None
                leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
                return [y.detach() for y in ys], torch.autograd.grad(ys, leaves, [g.to(dtype) for g in cot])

            with_grads = si == 0
            k = flat(lstm_seq_kernel(pb, xs, (h0, c0)))
            p, p_g = run(lstm_seq_plain, torch.bfloat16, with_grads)
            r, r_g = run(lstm_seq_plain, torch.float64, with_grads)
            st, st_g = run(f64_straight_through, torch.float64, with_grads)
            row = {"T": T, "B": B, "seed": seed, "dtype": "bfloat16"}
            readings = {}
            for name, a, b, ref, ref_st in zip(NAMES, k, p, r, st):
                readings.update({
                    f"{name}.b1_vs_plain": float((a.float() - b.float()).abs().max()),
                    f"{name}.b1_vs_f64": float((a.double() - ref).abs().max()),
                    f"{name}.plain_vs_f64": float((b.double() - ref).abs().max()),
                    f"{name}.b1_vs_f64_st": float((a.double() - ref_st).abs().max()),
                    f"{name}.plain_vs_f64_st": float((b.double() - ref_st).abs().max()),
                    f"{name}.max_abs_ref": float(ref.abs().max()),
                })
            if with_grads:
                d, d_g = run(lstm_seq_diff, torch.bfloat16, True)
                row["b2_forward_equals_b1"] = all(torch.equal(x, y) for x, y in zip(d, k))
                rel = lambda a, ref: float((a.double() - ref).abs().max() / ref.abs().max())
                for n, dg, pg, rg, sg in zip(["xs", "h0", "c0"] + wnames, d_g, p_g, r_g, st_g):
                    readings.update({f"grad.{n}.b2_vs_f64": rel(dg, rg), f"grad.{n}.plain_vs_f64": rel(pg, rg),
                                     f"grad.{n}.b2_vs_f64_st": rel(dg, sg),
                                     f"grad.{n}.plain_vs_f64_st": rel(pg, sg),
                                     f"grad.{n}.f64_st_vs_f64": rel(sg, rg)})
            row.update(readings)
            for key, v in readings.items():
                worst[key] = max(worst.get(key, 0.0), v)
            print(json.dumps(row), flush=True)
        print(json.dumps({"summary": f"{T}x{B}", "dtype": "bfloat16", "seeds": args.seeds, "max": worst,
                          "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--shapes", nargs="+", default=["80x128", "1x2048"])
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda")
    params = loaders.load_any(FLAGSHIP, device=dev).params.online.lstm
    if args.dtype == "bfloat16":
        return bf16_spread(args, params, card, dev)
    p64 = [{k: v.double() for k, v in p.items()} for p in params]
    L, H = len(params), params[0]["w_hh"].shape[0]
    for si, shape in enumerate(args.shapes):
        T, B = (int(v) for v in shape.split("x"))
        worst = {}
        for seed in range(args.seeds):
            gen = torch.Generator().manual_seed(seed)
            xs = torch.randn(T, B, H, generator=gen).to(dev)
            h0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
            c0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
            with torch.no_grad():
                k = flat(lstm_seq_kernel(params, xs, (h0, c0)))
                p = flat(lstm_seq_plain(params, xs, (h0, c0)))
                r = flat(lstm_seq_plain(p64, xs.double(), (h0.double(), c0.double())))
            row = {"T": T, "B": B, "seed": seed}
            for name, a, b, ref in zip(NAMES, k, p, r):
                reading = {
                    "b1_vs_plain": float((a - b).abs().max()),
                    "b1_vs_f64": float((a.double() - ref).abs().max()),
                    "plain_vs_f64": float((b.double() - ref).abs().max()),
                    "max_abs_ref": float(ref.abs().max()),
                }
                row[name] = reading
                for key, v in reading.items():
                    worst[f"{name}.{key}"] = max(worst.get(f"{name}.{key}", 0.0), v)
            if si == 0:
                leaves = [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
                ps = [{key: v.clone().requires_grad_(True) for key, v in q.items()} for q in params]
                d = flat(lstm_seq_diff(ps, leaves[0], (leaves[1], leaves[2])))
                g = flat(lstm_seq_plain(ps, leaves[0], (leaves[1], leaves[2])))
                row["b2_forward_equals_b1"] = all(torch.equal(x.detach(), y) for x, y in zip(d, k))
                row["plain_grad_mode_equals_no_grad"] = all(torch.equal(x.detach(), y) for x, y in zip(g, p))
            print(json.dumps(row), flush=True)
        print(json.dumps({"summary": f"{T}x{B}", "seeds": args.seeds, "max": worst, "card": card}), flush=True)


if __name__ == "__main__":
    main()

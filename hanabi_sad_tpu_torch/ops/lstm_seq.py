"""Kernel B1, the multi-layer LSTM over a sequence in float32 or bfloat16,
with its plain PyTorch version; and B2, the same LSTM made differentiable,
with a backward kernel and its plain version.

B1 is the counterpart of `hanabi_sad_tpu/ops/experimental/pallas_lstm.py:
lstm_seq_pallas` and of the scan in `hanabi_sad_tpu/models/lstm.py`.
`lstm_seq` launches the CUDA kernels of `csrc/lstm_seq.cu` (float32) or
`csrc/lstm_bf16.cu` (bfloat16) for a CUDA tensor and runs `lstm_seq_plain`
for a CPU tensor; for a CUDA tensor it launches the
kernels or raises, it never falls back. A call is L launches at T = 1 (the
gates kernel with the cell update, per layer) and 2 L at T > 1 (per layer,
the input projection for all T steps, then one persistent launch over the
steps).

B2 (`LstmSeqDiff`, called through `lstm_seq_diff`) is the counterpart of
`pallas_lstm.py:lstm_seq_pallas_diff`. Its forward is B1 (`lstm_seq_plain` on
the CPU) told to keep what the backward needs (`Saved`): each layer's gate
activations i, f, g, o, its cell states and its h sequence; the outputs are
the same bits as without. Its backward (`lstm_seq_bwd`) walks the layers top
down: the recurrence of backpropagation through time runs in the kernel of
`csrc/lstm_bwd.cu` or `csrc/lstm_bf16.cu` (`lstm_bwd_recurrence_plain` on
the CPU), and the
products that do not recur (dW_ih, dW_hh, db and dX) are batched matrix
products over all steps at once, as the JAX package leaves them to XLA in the
scan's VJP. Nothing recomputes the forward. `lstm_seq_bwd_plain` is the same
algorithm in plain PyTorch from the same saved tensors.

Layouts are the JAX package's: params is a list of per-layer
{"w_ih": [in, 4H], "w_hh": [H, 4H], "b": [4H]} (one collapsed bias, gate
order i, f, g, o); xs [T, B, in]; hidden (h, c) each [L, B, H].

Types: every tensor of a call is float32, or every one bfloat16 (the caller
casts the weights, as `pallas_lstm.py` casts them to `xs.dtype`). In
bfloat16 the semantics are `pallas_lstm.py:lstm_seq_pallas`'s: the products
of the bfloat16 values summed in float32, the bias added in float32, the
cell in float32, and h and c rounded to bfloat16 at every step, the next
step reading the rounded values. The saved gates and cell states are
float32 (the cell states are the rounded ones, which the next step read),
and B2's backward runs in float32 from them; it returns each grad in its
input's dtype. The bfloat16 kernels compute this on the tensor cores
(bfloat16 products, float32 sums); their backward's product takes each
float32 dG value as three bfloat16 terms (`split_bf16`), which add up to it
exactly, so it loses nothing to float32. They take H a multiple of 64 and at
most 512, and 16-byte aligned tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.ops import build

LSTMParams = List[Dict[str, torch.Tensor]]
Hidden = Tuple[torch.Tensor, torch.Tensor]


class Saved(NamedTuple):
    """What B2's forward keeps for its backward, per layer."""

    act: List[torch.Tensor]  # [T, B, 4H] float32: sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)
    cseq: List[torch.Tensor]  # [T, B, H] float32: c_t as stored (rounded to the compute dtype)
    hseq: List[torch.Tensor]  # [T, B, H]: h_t (the top layer's is the output)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype that sums and the cell are computed in: float32 for float32
    and bfloat16 (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def _cell_act(p: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM cell step in `_acc(x.dtype)` on the values of x, h, c and the
    weights. x: [B, in], h/c: [B, H]. Returns (h, c, rounded to x's dtype,
    and the activations [B, 4H] unrounded)."""
    a = _acc(x.dtype)
    gates = x.to(a) @ p["w_ih"].to(a) + h.to(a) @ p["w_hh"].to(a) + p["b"].to(a)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = f * c.to(a) + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype), (i, f, g, o)


def _cell(p: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM cell step. x: [B, in], h/c: [B, H]."""
    h_new, c_new, _ = _cell_act(p, x, h, c)
    return h_new, c_new


def lstm_seq_plain(params: LSTMParams, xs: torch.Tensor, hidden: Hidden, save: bool = False):
    """The plain version: a Python loop over time and layers of `_cell`, in
    xs's dtype (the weights and the hidden are rounded to it first, as
    `models/lstm.py:lstm_seq` casts them for the kernels). Returns (outs
    [T, B, H], (hT, cT) [L, B, H] in the hidden's dtype), and `Saved` as a
    third element if `save`."""
    dt, hdt = xs.dtype, hidden[0].dtype
    h = list(hidden[0].to(dt).unbind(0))
    c = list(hidden[1].to(dt).unbind(0))
    params = [{k: v.to(dt).to(_acc(dt)) for k, v in p.items()} for p in params]  # one cast a call
    acts, cs, hs = ([[] for _ in params] for _ in range(3))
    outs = []
    for x in xs.unbind(0):
        for layer, p in enumerate(params):
            h[layer], c[layer], a = _cell_act(p, x, h[layer], c[layer])
            if save:
                acts[layer].append(torch.cat(a, dim=-1))
                cs[layer].append(c[layer].to(_acc(dt)))
                hs[layer].append(h[layer])
            x = h[layer]
        outs.append(x)
    result = (torch.stack(outs), (torch.stack(h).to(hdt), torch.stack(c).to(hdt)))
    if not save:
        return result
    stack = lambda seqs: [torch.stack(s) for s in seqs]
    return result + (Saved(stack(acts), stack(cs), stack(hs)),)


DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the kernels' element types


def split_bf16(x: torch.Tensor, terms: int = 3) -> List[torch.Tensor]:
    """x (float32) as `terms` bfloat16 tensors whose float32 sum is x, as
    the bfloat16 backward kernel splits dG (`csrc/lstm_mma.cuh:split3_bf16`):
    each term rounds (nearest even) what the terms before it left, and each
    remainder is exact in float32. Three terms hold a float32 value's 24
    significant bits exactly (for normal values), two hold 16."""
    out, rest = [], x
    for _ in range(terms):
        out.append(rest.bfloat16())
        rest = rest - out[-1].float()
    return out


def _check_cuda(tensors, what: str) -> str:
    """Checks that every tensor lies on one CUDA device, is contiguous and
    has one dtype, float32 or bfloat16; returns that dtype's suffix of the
    kernels' entry points."""
    device, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what} kernel needs CUDA tensors")
        if t.dtype != dtype:
            raise ValueError(f"{what} kernel takes one dtype a call, got {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous tensors")
        if t.device != device:
            raise ValueError(f"{what} kernel needs every tensor on one device")
    return DTYPES[dtype]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _load_kernels(sources: Dict[str, str], h_rules, argtypes):
    """Builds (at first use, one nvcc per source, in parallel) and loads the
    libraries of `sources` ({dtype suffix: source}), and binds each suffix's
    entry points `<name>_<suffix>` with `argtypes[name]`, returning an int.
    `h_rules` names each suffix's entry points that give the H multiple and
    the largest H (None: no largest). Returns ({suffix: {name: fn}}, {suffix:
    (H multiple, largest H or None)}, {source: the -Xptxas -v lines of this
    build, empty if it was built before})."""
    built = build.build_many(list(sources.values()))
    fns, h_rule = {}, {}
    for suffix, source in sources.items():
        lib = built[source][0]
        fns[suffix] = {}
        for name, types in argtypes.items():
            fn = fns[suffix][name] = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = types, ctypes.c_int
        multiple, largest = h_rules[suffix]
        h_rule[suffix] = (getattr(lib, multiple)(), None if largest is None else getattr(lib, largest)())
    return fns, h_rule, {source: built[source][1] for source in sources.values()}


def _check_shape(h_rule, suffix: str, H: int, tensors, what: str):
    """Raises if the `suffix` kernels do not take hidden size H, or (bfloat16,
    whose kernels copy 16 bytes at a time) a tensor is not 16-byte aligned."""
    multiple, largest = h_rule[suffix]
    if H % multiple != 0 or (largest is not None and H > largest):
        cond = f"H % {multiple} == 0" + (f" and H <= {largest}" if largest is not None else "")
        raise ValueError(f"{what} {suffix} kernels need {cond}, got H={H}")
    if suffix == "bf16" and any(t is not None and t.data_ptr() % 16 != 0 for t in tensors):
        raise ValueError(f"{what} bf16 kernels need 16-byte aligned tensors")


class LstmSeqKernel:
    """Wrapper of B1's CUDA kernels. `launches` counts kernel launches (L per
    call at T = 1, 2 L at T > 1), `launches_by_kernel` splits them into
    "gates" and "recurrence", `launches_by_dtype` into "f32" and "bf16"
    (the entry points `lstm_*_f32` of `csrc/lstm_seq.cu` and `lstm_*_bf16`
    of `csrc/lstm_bf16.cu`), `calls` counts calls; all are plain integers
    that a caller may reset."""

    sources = {"f32": "lstm_seq.cu", "bf16": "lstm_bf16.cu"}
    h_rules = {"f32": ("lstm_h_multiple", None), "bf16": ("lstm_bf16_h_multiple", "lstm_bf16_h_max")}

    def __init__(self):
        self.launches = 0
        self.launches_by_kernel = {"gates": 0, "recurrence": 0}
        self.launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)
        self.calls = 0
        self._fns = None
        self.ptxas: Dict[str, List[str]] = {}

    def load(self):
        """Build (at first use) and bind the libraries; returns {dtype
        suffix: {"lstm_gates": fn, "lstm_recurrence": fn}}."""
        if self._fns is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            argtypes = {"lstm_gates": [p, p, i, p, p, i] + [p] * 8 + [i, i, p],
                        "lstm_recurrence": [p] * 9 + [i, i, i, p]}
            self._fns, self._h_rule, self.ptxas = _load_kernels(self.sources, self.h_rules, argtypes)
        return self._fns

    def reset(self):
        self.launches = self.calls = 0
        self.launches_by_kernel = {k: 0 for k in self.launches_by_kernel}
        self.launches_by_dtype = {k: 0 for k in self.launches_by_dtype}

    def _launched(self, kernel: str, suffix: str, err: int):
        if err != 0:
            raise RuntimeError(f"lstm_{kernel}_{suffix} launch failed with CUDA error {err}")
        self.launches += 1
        self.launches_by_kernel[kernel] += 1
        self.launches_by_dtype[suffix] += 1

    def __call__(self, params: LSTMParams, xs: torch.Tensor, hidden: Hidden, save: bool = False):
        h0, c0 = hidden
        if xs.dim() != 3 or xs.shape[0] < 1 or xs.shape[1] < 1:
            raise ValueError(f"xs must be [T, B, H] with T, B >= 1, got {tuple(xs.shape)}")
        T, B, H = xs.shape
        L = len(params)
        suffix = _check_cuda([xs, h0, c0] + _flatten(params), "lstm_seq")
        if h0.shape != (L, B, H) or c0.shape != (L, B, H):
            raise ValueError(f"hidden must be [{L}, {B}, {H}], got {tuple(h0.shape)}, {tuple(c0.shape)}")
        for p in params:
            if p["w_ih"].shape != (H, 4 * H):
                raise ValueError(f"lstm_seq kernel needs in_dim == hid_dim: w_ih {tuple(p['w_ih'].shape)}")
            if p["w_hh"].shape != (H, 4 * H) or p["b"].shape != (4 * H,):
                raise ValueError("w_hh must be [H, 4H] and b [4H]")
        fns = self.load()[suffix]
        gates_fn, recurrence_fn = fns["lstm_gates"], fns["lstm_recurrence"]
        _check_shape(self._h_rule, suffix, H, [xs, h0, c0] + _flatten(params), "lstm_seq")

        with torch.cuda.device(xs.device):
            stream = torch.cuda.current_stream().cuda_stream
            new = lambda *shape, dtype=xs.dtype: torch.empty(shape, dtype=dtype, device=xs.device)
            outs, h_t, c_t = new(T, B, H), new(L, B, H), new(L, B, H)
            hseq = [new(T, B, H) for _ in range(L - 1)] + [outs]
            act = new(L, T, B, 4 * H, dtype=torch.float32) if save else None
            cseq = new(L, T, B, H, dtype=torch.float32) if save else None
            gx = new(T * B, 4 * H, dtype=torch.float32) if T > 1 else None
            for layer, p in enumerate(params):
                x = xs if layer == 0 else hseq[layer - 1]
                a_l = act[layer] if save else None
                c_l = cseq[layer] if save else None
                if T == 1:
                    err = gates_fn(
                        x.data_ptr(), p["w_ih"].data_ptr(), H, h0[layer].data_ptr(), p["w_hh"].data_ptr(), H,
                        p["b"].data_ptr(), c0[layer].data_ptr(), None, h_t[layer].data_ptr(),
                        c_t[layer].data_ptr(), hseq[layer].data_ptr(), _ptr(a_l), _ptr(c_l), B, H, stream,
                    )
                    self._launched("gates", suffix, err)
                    continue
                err = gates_fn(
                    x.data_ptr(), p["w_ih"].data_ptr(), H, None, None, 0, p["b"].data_ptr(), None,
                    gx.data_ptr(), None, None, None, None, None, T * B, H, stream,
                )
                self._launched("gates", suffix, err)
                err = recurrence_fn(
                    gx.data_ptr(), h0[layer].data_ptr(), c0[layer].data_ptr(), p["w_hh"].data_ptr(),
                    hseq[layer].data_ptr(), h_t[layer].data_ptr(), c_t[layer].data_ptr(),
                    _ptr(a_l), _ptr(c_l), T, B, H, stream,
                )
                self._launched("recurrence", suffix, err)
            self.calls += 1
        if not save:
            return outs, (h_t, c_t)
        return outs, (h_t, c_t), Saved(list(act.unbind(0)), list(cseq.unbind(0)), hseq)


lstm_seq_kernel = LstmSeqKernel()


def lstm_seq(params: LSTMParams, xs: torch.Tensor, hidden: Hidden):
    """Sequence LSTM: the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor. Returns (outs [T, B, H], (hT, cT) [L, B, H])."""
    if xs.is_cuda:
        return lstm_seq_kernel(params, xs, hidden)
    return lstm_seq_plain(params, xs, hidden)


def lstm_bwd_recurrence_plain(dout, gh, gc, act, cseq, c0, w_hh):
    """The plain version of the backward kernel: BPTT through one layer, in
    dout's dtype (float32 for a bfloat16 c0 and w_hh, the kernel's types).
    dout [T, B, H] (the grad of the layer's h sequence), gh, gc [B, H] or
    None (the grads of hT, cT), act [T, B, 4H], cseq [T, B, H], c0 [B, H],
    w_hh [H, 4H]. Returns (dG [T, B, 4H], the grads of the gate
    pre-activations; dh0 [B, H]; dc0 [B, H])."""
    T = dout.shape[0]
    c0, w_hh = c0.to(dout.dtype), w_hh.to(dout.dtype)
    dg = dout.new_empty(dout.shape[:-1] + (act.shape[-1],))
    carry = gc if gc is not None else torch.zeros_like(dout[0])
    for t in reversed(range(T)):
        rec = gh if t == T - 1 else dg[t + 1] @ w_hh.t()
        dh = dout[t] if rec is None else dout[t] + rec
        i, f, g, o = act[t].chunk(4, dim=-1)
        tc = torch.tanh(cseq[t])
        c_prev = cseq[t - 1] if t > 0 else c0
        dc = dh * o * (1 - tc * tc) + carry
        dg[t] = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f), dc * i * (1 - g * g),
                           dh * tc * o * (1 - o)], dim=-1)
        carry = dc * f
    return dg, dg[0] @ w_hh.t(), carry


class LstmBwdKernel:
    """Wrapper of B2's backward kernel, one launch per layer; called as
    `lstm_bwd_recurrence_plain` is. c0 and w_hh are float32 (`lstm_bwd_f32`
    of `csrc/lstm_bwd.cu`) or bfloat16 (`lstm_bwd_bf16` of
    `csrc/lstm_bf16.cu`), the rest float32. `launches` counts kernel
    launches, `launches_by_dtype` splits them by entry point; a caller may
    reset both."""

    sources = {"f32": "lstm_bwd.cu", "bf16": "lstm_bf16.cu"}
    h_rules = {"f32": ("lstm_bwd_h_multiple", None), "bf16": ("lstm_bf16_h_multiple", "lstm_bf16_h_max")}

    def __init__(self):
        self.reset()
        self._fns = None
        self.ptxas: Dict[str, List[str]] = {}

    def reset(self):
        self.launches = 0
        self.launches_by_dtype = dict.fromkeys(DTYPES.values(), 0)

    def load(self):
        """Build (at first use) and bind the libraries; returns {dtype
        suffix: fn}."""
        if self._fns is None:
            argtypes = {"lstm_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
            fns, self._h_rule, self.ptxas = _load_kernels(self.sources, self.h_rules, argtypes)
            self._fns = {k: v["lstm_bwd"] for k, v in fns.items()}
        return self._fns

    def __call__(self, dout, gh, gc, act, cseq, c0, w_hh):
        T, B, H = dout.shape
        _check_cuda([dout, act, cseq] + [g for g in (gh, gc) if g is not None], "lstm_bwd")
        suffix = _check_cuda([c0, w_hh], "lstm_bwd")
        if c0.device != dout.device:
            raise ValueError("lstm_bwd kernel needs every tensor on one device")
        shapes = {"act": (act, (T, B, 4 * H)), "cseq": (cseq, (T, B, H)), "c0": (c0, (B, H)),
                  "w_hh": (w_hh, (H, 4 * H)), "gh": (gh, (B, H)), "gc": (gc, (B, H))}
        for name, (t, shape) in shapes.items():
            if t is not None and tuple(t.shape) != shape:
                raise ValueError(f"lstm_bwd kernel: {name} must be {list(shape)}, got {list(t.shape)}")
        fn = self.load()[suffix]
        _check_shape(self._h_rule, suffix, H, [dout, gh, gc, act, cseq, c0, w_hh], "lstm_bwd")
        with torch.cuda.device(dout.device):
            dg = torch.empty((T, B, 4 * H), dtype=dout.dtype, device=dout.device)
            dh0, dc0 = torch.empty_like(dout[0]), torch.empty_like(dout[0])
            err = fn(
                dout.data_ptr(), _ptr(gh), _ptr(gc), act.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                w_hh.data_ptr(), dg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H,
                torch.cuda.current_stream().cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"lstm_bwd_{suffix} launch failed with CUDA error {err}")
            self.launches += 1
            self.launches_by_dtype[suffix] += 1
        return dg, dh0, dc0


lstm_bwd_kernel = LstmBwdKernel()


def _dx(dg: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """dX = dG . w_ih^T in dG's dtype for dG [T, B, 4H], its K = 4H cut into
    slices of 256 whose products are added in slice order: one product over
    all 4H and all T * B rows rounded further from float64 than the plain
    version's per-step products on the card."""
    w_ih = w_ih.to(dg.dtype)
    T, B, G = dg.shape
    S = G // 256 if G % 256 == 0 else 1
    parts = torch.bmm(dg.reshape(T * B, S, G // S).transpose(0, 1), w_ih.t().reshape(S, G // S, -1))
    return parts.sum(0).reshape(T, B, -1)


def _lstm_seq_bwd(recurrence, params, xs, hidden, saved: Saved, g_outs, g_h, g_c, needs=None):
    """The backward of the sequence LSTM, layer by layer from the top: the
    recurrence gives dG, then dW_ih = sum_t X_t^T dG_t, dW_hh = sum_t
    H_{t-1}^T dG_t and db = sum_t sum_b dG_t (a product per step, then a sum
    over the steps, as the plain version's autograd adds them), and dX by
    `_dx`. Every reduction runs in a fixed order. It computes in
    `_acc(xs.dtype)`, float32 for a bfloat16 call (a bfloat16 input is upcast
    where it enters), and returns each grad in its input's dtype. needs:
    which of (xs, h0, c0, w_ih_0, w_hh_0, b_0, ...) want a grad (all if
    None). Returns their grads in that order, None where not wanted."""
    h0, c0 = hidden
    L = len(params)
    needs = needs if needs is not None else (True,) * (3 + 3 * L)
    acc = _acc(xs.dtype)
    up = lambda t: t.to(acc) if t is not None else None
    dout = up(g_outs) if g_outs is not None else torch.zeros_like(saved.hseq[-1], dtype=acc)
    g_h, g_c = up(g_h), up(g_c)
    layer_grads: List[Optional[torch.Tensor]] = [None] * (3 * L)
    dh0, dc0, g_xs = [None] * L, [None] * L, None
    for layer in reversed(range(L)):
        p = params[layer]
        gh = g_h[layer].contiguous() if g_h is not None else None
        gc = g_c[layer].contiguous() if g_c is not None else None
        dg, dh0[layer], dc0[layer] = recurrence(
            dout.contiguous(), gh, gc, saved.act[layer], saved.cseq[layer], c0[layer], p["w_hh"])
        x = xs if layer == 0 else saved.hseq[layer - 1]
        want = needs[3 + 3 * layer : 6 + 3 * layer]
        if want[0]:
            layer_grads[3 * layer] = torch.bmm(x.to(acc).transpose(1, 2), dg).sum(0).to(p["w_ih"].dtype)
        if want[1]:
            h_prev = torch.cat([h0[layer][None], saved.hseq[layer][:-1]]).to(acc)
            layer_grads[3 * layer + 1] = torch.bmm(h_prev.transpose(1, 2), dg).sum(0).to(p["w_hh"].dtype)
        if want[2]:
            layer_grads[3 * layer + 2] = dg.sum(1).sum(0).to(p["b"].dtype)
        if layer > 0 or needs[0]:
            dx = _dx(dg, p["w_ih"])
            if layer > 0:
                dout = dx
            else:
                g_xs = dx.to(xs.dtype)
    g_h0 = torch.stack(dh0).to(h0.dtype) if needs[1] else None
    g_c0 = torch.stack(dc0).to(c0.dtype) if needs[2] else None
    return (g_xs, g_h0, g_c0, *layer_grads)


def lstm_seq_bwd(params, xs, hidden, saved: Saved, g_outs, g_h, g_c, needs=None):
    """B2's backward on the card: the recurrence in the kernel of
    `csrc/lstm_bwd.cu`. Arguments and result as `_lstm_seq_bwd`."""
    return _lstm_seq_bwd(lstm_bwd_kernel, params, xs, hidden, saved, g_outs, g_h, g_c, needs)


def lstm_seq_bwd_plain(params, xs, hidden, saved: Saved, g_outs, g_h, g_c, needs=None):
    """The plain version of B2's backward: the same algorithm with the
    recurrence in `lstm_bwd_recurrence_plain`."""
    return _lstm_seq_bwd(lstm_bwd_recurrence_plain, params, xs, hidden, saved, g_outs, g_h, g_c, needs)


class LstmSeqDiff(torch.autograd.Function):
    """Kernel B2: `lstm_seq` differentiable in xs, h0, c0 and every weight.

    Arguments: (num_layers, xs, h0, c0, w_ih_0, w_hh_0, b_0, w_ih_1, ...).
    Returns (outs [T, B, H], hT, cT [L, B, H]). On CUDA tensors the forward
    is B1 with its save pointers and the backward `lstm_seq_bwd`; on CPU
    tensors `lstm_seq_plain(save=True)` and `lstm_seq_bwd_plain`. `calls`
    counts forward calls; a caller may reset it."""

    calls = 0

    @staticmethod
    def forward(ctx, num_layers: int, xs, h0, c0, *flat):
        params = _unflatten(num_layers, flat)
        fwd = lstm_seq_kernel if xs.is_cuda else lstm_seq_plain
        outs, (h_t, c_t), saved = fwd(params, xs, (h0, c0), save=True)
        ctx.num_layers = num_layers
        ctx.set_materialize_grads(False)  # an unused output's grad stays None
        ctx.save_for_backward(xs, h0, c0, outs, *flat)
        # The top layer's h sequence is outs, saved above with the inputs.
        ctx.saved = saved._replace(hseq=saved.hseq[:-1])
        LstmSeqDiff.calls += 1
        return outs, h_t, c_t

    @staticmethod
    def backward(ctx, g_outs, g_h, g_c):
        xs, h0, c0, outs, *flat = ctx.saved_tensors
        saved = ctx.saved._replace(hseq=ctx.saved.hseq + [outs])
        bwd = lstm_seq_bwd if xs.is_cuda else lstm_seq_bwd_plain
        grads = bwd(_unflatten(ctx.num_layers, flat), xs, (h0, c0), saved, g_outs, g_h, g_c,
                    ctx.needs_input_grad[1:])
        return (None, *grads)


def _flatten(params: LSTMParams) -> List[torch.Tensor]:
    return [p[k] for p in params for k in ("w_ih", "w_hh", "b")]


def _unflatten(num_layers: int, flat) -> LSTMParams:
    return [
        {"w_ih": flat[3 * l], "w_hh": flat[3 * l + 1], "b": flat[3 * l + 2]}
        for l in range(num_layers)
    ]


def lstm_seq_diff(params: LSTMParams, xs: torch.Tensor, hidden: Hidden):
    """B2: sequence LSTM with gradients to xs, hidden and params. Returns
    (outs [T, B, H], (hT, cT) [L, B, H])."""
    outs, h_t, c_t = LstmSeqDiff.apply(len(params), xs, hidden[0], hidden[1], *_flatten(params))
    return outs, (h_t, c_t)

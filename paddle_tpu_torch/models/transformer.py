"""Transformer-base NMT incremental (KV-cached) decode on PyTorch
(counterpart of `paddle_tpu/models/transformer.py`: `TransformerConfig`
:19, `convert_qkv_checkpoint` :248, `_ln_index` :284, `decode_params`
:296 and `IncrementalDecoder` :327 with the fp32 and the int8 cache).

The JAX decoder jit-compiles one prefill per row bucket and one step
function and donates the cache buffers to them. The port runs eagerly:
the cache tensors are updated in place, which stands in for donation.
On the card the step's self-attention over the slot pool is a
hand-written CUDA kernel: `ops.kern.decode_attention.decode_attend`
over the fp32 cache, or `dequant_attend` over the int8 cache, whose
rows `ops.kern.quant.quantize_int8_blockwise` (a CUDA kernel too)
quantizes as they are written. On the CPU the same calls take their
plain versions. Weights arrive as numpy arrays in either checkpoint
layout through `params_from_numpy`.
"""
import numpy as np
import torch

from ..device import resolve_device
from ..ops.kern.decode_attention import decode_attend, dequant_attend
from ..ops.kern.quant import quantize_int8_blockwise
from ..ops.kernels_nn import _attn_softmax

__all__ = ["TransformerConfig", "convert_qkv_checkpoint", "param_shapes",
           "decode_params", "params_from_numpy", "IncrementalDecoder"]


class TransformerConfig:
    def __init__(self, src_vocab=10000, trg_vocab=10000, max_len=256,
                 d_model=512, d_inner=2048, n_head=8, n_layer=6,
                 dropout=0.1, label_smooth_eps=0.1, fused_qkv=False):
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.max_len = max_len
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        self.fused_qkv = fused_qkv

    @staticmethod
    def base():
        return TransformerConfig()

    @staticmethod
    def tiny():
        return TransformerConfig(src_vocab=128, trg_vocab=128, max_len=32,
                                 d_model=64, d_inner=128, n_head=4,
                                 n_layer=2, dropout=0.0)


def convert_qkv_checkpoint(arrays, cfg, to_fused):
    """Convert a parameter dict between the UNFUSED (per-projection
    enc{i}_q.w_0 / _k / _v) and FUSED (enc{i}_qkv.w_0,
    dec{i}_cross_kv.w_0) checkpoint layouts, in either direction.
    Returns a new dict; other entries pass through unchanged. Fusion
    order is [q | k | v] (or [k | v]) along the output axis."""
    out = dict(arrays)

    def fuse(base, parts, fused_name):
        names = [f"{base}_{p}.w_0" for p in parts]
        if not all(n in out for n in names):
            return
        ws = [out.pop(n) for n in names]
        out[fused_name] = np.concatenate(ws, axis=1)

    def split(base, parts, fused_name):
        if fused_name not in out:
            return
        w = out.pop(fused_name)
        pieces = np.split(w, len(parts), axis=1)
        for p, piece in zip(parts, pieces):
            out[f"{base}_{p}.w_0"] = piece

    op = fuse if to_fused else split
    for i in range(cfg.n_layer):
        op(f"enc{i}", ("q", "k", "v"), f"enc{i}_qkv.w_0")
        op(f"dec{i}_self", ("q", "k", "v"), f"dec{i}_self_qkv.w_0")
        op(f"dec{i}_cross", ("k", "v"), f"dec{i}_cross_kv.w_0")
    return out


def _ln_index(cfg, part, layer, sub):
    """Layer-norm parameter index in the order the training program
    builds them: encoder layer i has layer_norm_{2i} (attn) and
    _{2i+1} (ffn); decoder layer i has _{2L+3i} (self), +1 (cross),
    +2 (ffn)."""
    L = cfg.n_layer
    if part == "enc":
        return 2 * layer + {"attn": 0, "ffn": 1}[sub]
    return 2 * L + 3 * layer + {"self": 0, "cross": 1, "ffn": 2}[sub]


def param_shapes(cfg):
    """{name: shape} of the decode parameters in the unfused layout, in
    the order the training program names them."""
    D, F = cfg.d_model, cfg.d_inner
    shapes = {"src_emb.w_0": (cfg.src_vocab, D),
              "trg_emb.w_0": (cfg.trg_vocab, D),
              "proj.w_0": (D, cfg.trg_vocab)}
    for i in range(cfg.n_layer):
        for base in (f"enc{i}", f"dec{i}_self", f"dec{i}_cross"):
            for p in "qkvo":
                shapes[f"{base}_{p}.w_0"] = (D, D)
        for part in (f"enc{i}_ffn", f"dec{i}_ffn"):
            shapes[f"{part}_fc1.w_0"] = (D, F)
            shapes[f"{part}_fc1.b_0"] = (F,)
            shapes[f"{part}_fc2.w_0"] = (F, D)
            shapes[f"{part}_fc2.b_0"] = (D,)
    for j in range(5 * cfg.n_layer):        # 2L encoder + 3L decoder
        shapes[f"layer_norm_{j}.w_0"] = (D,)
        shapes[f"layer_norm_{j}.b_0"] = (D,)
    return shapes


def decode_params(arrays, cfg):
    """Validate and normalize a transformer parameter dict for
    incremental decode. Accepts both checkpoint layouts (the fused one
    is split back by `convert_qkv_checkpoint`). Returns a new
    {name: array} dict restricted to the decode parameters; raises
    KeyError naming the missing parameters on a mismatch."""
    arrays = dict(arrays)
    if any(k.endswith("_qkv.w_0") or k.endswith("_kv.w_0")
           for k in arrays):
        arrays = convert_qkv_checkpoint(arrays, cfg, to_fused=False)
    need = param_shapes(cfg)
    missing = sorted(n for n in need if n not in arrays)
    if missing:
        raise KeyError(
            f"decode_params: {len(missing)} transformer parameters "
            f"missing (config mismatch or foreign checkpoint?): "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}")
    return {n: arrays[n] for n in need}


def params_from_numpy(arrays, cfg, device=None):
    """The JAX package's parameters as numpy arrays (either checkpoint
    layout) -> the port's {name: fp32 torch.Tensor} on `device` (the
    card unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    return {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
            for n, a in decode_params(arrays, cfg).items()}


def _pe(T, D, device):
    """Sinusoidal position table [T, D] in f32, as the
    add_position_encoding kernel computes it."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _ln(x, scale, bias, eps=1e-5):
    """Layer norm over the last axis with f32 internals."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.reshape(-1) + bias.reshape(-1)).to(x.dtype)


def _fc(x, w, b=None, relu=False):
    """Matmul over the flattened leading dims, + bias, + relu."""
    lead = x.shape[:-1]
    out = (x.reshape(-1, x.shape[-1]) @ w).reshape(*lead, w.shape[1])
    if b is not None:
        out = out + b.reshape(-1)
    if relu:
        out = torch.relu(out)
    return out


class IncrementalDecoder:
    """KV-cached single-token transformer decode over a fixed slot
    pool — the compute core of `paddle_tpu_torch.serving.decode`.

    State is a static-shape cache ``kc/vc [n_layer, num_slots, max_len,
    n_head, d_head]`` plus the cross-attention caches. ``prefill(src,
    src_len)`` runs the encoder and the per-layer cross K/V projections;
    ``step(state, ids, pos)`` embeds each slot's current token, writes
    its self-attention K/V into the cache at ``pos`` in place, attends
    over t <= pos through the decode-attention kernel and returns the
    next token id per slot (greedy argmax, or top-k sampling drawn with
    a `torch.Generator` seeded from ``seed``, which cannot match
    `jax.random`'s draws). Slots are independent rows, so continuous
    batching is token-identical to one-at-a-time decode.

    ``device`` defaults to the card and raises without one; pass
    ``"cpu"`` to run the plain versions on the CPU. ``kv_quant="int8"``
    stores the self-attention caches as int8 codes with fp32 absmax
    scales over ``kv_block``-wide blocks of the head dim (default: the
    whole head), quantized as each row is written and dequantized
    inside the attention kernel; the cross-attention caches stay fp32.
    With ``return_logits`` the step keeps the [S, V] logits on
    ``last_logits`` (numpy).
    """

    def __init__(self, cfg, params, num_slots, max_len=None,
                 src_max_len=None, topk=0, temperature=1.0,
                 device=None, kv_quant=None, kv_block=None,
                 return_logits=False):
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or cfg.max_len)
        self.src_max_len = int(src_max_len or self.max_len)
        if self.num_slots < 1 or self.max_len < 2:
            raise ValueError("need num_slots >= 1 and max_len >= 2")
        self.topk = int(topk)
        self.temperature = float(temperature)
        if kv_quant in ("", "fp32", "none"):
            kv_quant = None
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant={kv_quant!r} not in "
                             f"(None, 'int8')")
        self.kv_quant = kv_quant
        Dh = cfg.d_model // cfg.n_head
        self.kv_block = int(kv_block or Dh)
        if self.kv_quant and (self.kv_block < 1
                              or Dh % self.kv_block != 0):
            raise ValueError(
                f"kv_block={self.kv_block} must divide the head dim "
                f"{Dh} so scales broadcast over whole blocks")
        self.device = resolve_device(device)
        self.return_logits = bool(return_logits)
        self.last_logits = None
        self.params = params_from_numpy(params, cfg, self.device)
        self._pe = _pe(max(self.max_len, self.src_max_len), cfg.d_model,
                       self.device)
        self._rows = torch.arange(self.num_slots, device=self.device)

    def load_params(self, arrays):
        """Swap in a new parameter set of the same shapes (rolling
        weight update)."""
        new = decode_params(arrays, self.cfg)
        for k, old in self.params.items():
            shp = tuple(np.asarray(new[k]).shape)
            if shp != tuple(old.shape):
                raise ValueError(
                    f"rolling update changed the shape of {k}: "
                    f"{tuple(old.shape)} -> {shp}; weight updates "
                    f"must keep the serving architecture")
        self.params = params_from_numpy(new, self.cfg, self.device)

    # ---------------------------------------------------------- state
    @property
    def max_new_tokens(self):
        """Generated-token capacity per slot (position 0 is bos)."""
        return self.max_len - 1

    def _dims(self):
        cfg = self.cfg
        return (cfg.n_layer, self.num_slots, self.max_len,
                self.src_max_len, cfg.n_head, cfg.d_model // cfg.n_head)

    def init_state(self):
        """Fresh slot state on this decoder's device: kc/vc
        [L,S,T,H,Dh] self-attention caches (or, with kv_quant="int8",
        kc_q/vc_q int8 codes and kc_s/vc_s fp32 scales
        [L,S,T,H,Dh/kv_block]), ck/cv [L,S,Ts,H,Dh] cross-attention
        caches, src_bias [S,1,1,Ts]."""
        L, S, T, Ts, H, Dh = self._dims()

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if self.kv_quant == "int8":
            nb = Dh // self.kv_block
            state = {"kc_q": z(L, S, T, H, Dh, dtype=torch.int8),
                     "kc_s": z(L, S, T, H, nb),
                     "vc_q": z(L, S, T, H, Dh, dtype=torch.int8),
                     "vc_s": z(L, S, T, H, nb)}
        else:
            state = {"kc": z(L, S, T, H, Dh), "vc": z(L, S, T, H, Dh)}
        state.update(ck=z(L, S, Ts, H, Dh), cv=z(L, S, Ts, H, Dh),
                     src_bias=z(S, 1, 1, Ts))
        return state

    def kv_cache_bytes(self):
        """Analytic slot-state footprint in bytes (self-attention codes
        and scales or fp32 caches, cross-attention caches, src bias)."""
        L, S, T, Ts, H, Dh = self._dims()
        n_self = L * S * T * H * Dh
        if self.kv_quant == "int8":
            self_b = 2 * (n_self + (n_self // self.kv_block) * 4)
        else:
            self_b = 2 * n_self * 4
        return self_b + 2 * L * S * Ts * H * Dh * 4 + S * Ts * 4

    # --------------------------------------------------------- running
    @torch.no_grad()
    def prefill(self, src, src_len):
        """Encoder forward for `rows = src.shape[0]` sequences padded to
        src_max_len. Returns (ck, cv, src_bias) shaped [L, rows, Ts, H,
        Dh] / [rows, 1, 1, Ts]."""
        cfg, p, dev = self.cfg, self.params, self.device
        L, _S, _T, Ts, H, Dh = self._dims()
        D = cfg.d_model
        src = np.asarray(src)
        rows, width = src.shape
        if width != Ts:
            raise ValueError(f"src padded to {width}, decoder built for "
                             f"src_max_len={Ts}")
        ids = torch.from_numpy(
            np.clip(src, 0, cfg.src_vocab - 1).astype(np.int64)).to(dev)
        lens = torch.from_numpy(
            np.asarray(src_len).astype(np.int64).reshape(rows)).to(dev)
        mask = (torch.arange(Ts, device=dev)[None, :]
                < lens[:, None]).float()
        src_bias = (mask * 1e9 - 1e9)[:, None, None, :]
        scale = Dh ** -0.5
        x = p["src_emb.w_0"][ids] * float(np.sqrt(D)) + self._pe[:Ts][None]
        for i in range(L):
            res = x
            q = _fc(x, p[f"enc{i}_q.w_0"]).reshape(rows, Ts, H, Dh)
            k = _fc(x, p[f"enc{i}_k.w_0"]).reshape(rows, Ts, H, Dh)
            v = _fc(x, p[f"enc{i}_v.w_0"]).reshape(rows, Ts, H, Dh)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            w = _attn_softmax(logits + src_bias).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(rows, Ts, D)
            x = self._norm(_fc(o, p[f"enc{i}_o.w_0"]) + res, "enc", i,
                           "attn")
            res = x
            h = _fc(x, p[f"enc{i}_ffn_fc1.w_0"], p[f"enc{i}_ffn_fc1.b_0"],
                    relu=True)
            h = _fc(h, p[f"enc{i}_ffn_fc2.w_0"], p[f"enc{i}_ffn_fc2.b_0"])
            x = self._norm(h + res, "enc", i, "ffn")
        ck = torch.stack([_fc(x, p[f"dec{i}_cross_k.w_0"]).reshape(
            rows, Ts, H, Dh) for i in range(L)])
        cv = torch.stack([_fc(x, p[f"dec{i}_cross_v.w_0"]).reshape(
            rows, Ts, H, Dh) for i in range(L)])
        return ck, cv, src_bias

    def _norm(self, x, part, i, sub):
        j = _ln_index(self.cfg, part, i, sub)
        return _ln(x, self.params[f"layer_norm_{j}.w_0"],
                   self.params[f"layer_norm_{j}.b_0"])

    @torch.no_grad()
    def write_slots(self, state, prefill_out, slots):
        """Copy `len(slots)` prefilled rows into the slot state in place
        (the bucket-pad rows are dropped)."""
        ck, cv, src_bias = prefill_out
        n = len(slots)
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.device)
        state["ck"][:, idx] = ck[:, :n]
        state["cv"][:, idx] = cv[:, :n]
        state["src_bias"][idx] = src_bias[:n]
        return state

    def _write_int8(self, codes, scales, i, pos_l, new):
        """Quantize the new rows `new` [S, H*Dh] in kv_block-wide blocks
        and write their codes and scales at (layer i, slot, pos) in
        place (the reference's int8 `cache_write`)."""
        S, H = self.num_slots, self.cfg.n_head
        Dh = self.cfg.d_model // H
        q8, sc = quantize_int8_blockwise(new.reshape(-1),
                                         block_size=self.kv_block)
        codes[i, self._rows, pos_l] = q8.reshape(S, H, Dh)
        scales[i, self._rows, pos_l] = sc.reshape(S, H, Dh // self.kv_block)

    @torch.no_grad()
    def step(self, state, ids, pos, seed=0):
        """One decode iteration for ALL slots: the current token id and
        position per slot in, the next token id per slot out (numpy
        int32 [num_slots]). The caches in `state` update in place. Free
        slots compute garbage lanes that the scheduler ignores."""
        cfg, p, dev = self.cfg, self.params, self.device
        L, S, T, _Ts, H, Dh = self._dims()
        D, V = cfg.d_model, cfg.trg_vocab
        ids = np.asarray(ids).reshape(-1)
        pos = np.asarray(pos).reshape(-1)
        if ids.shape != (S,) or pos.shape != (S,):
            raise ValueError(f"step wants ids and pos of shape ({S},); "
                             f"got {ids.shape} and {pos.shape}")
        if pos.min() < 0 or pos.max() >= T:
            raise ValueError(f"decode positions must lie in [0, {T}); "
                             f"got [{pos.min()}, {pos.max()}]")
        ids_t = torch.from_numpy(
            np.clip(ids, 0, V - 1).astype(np.int64)).to(dev)
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
        pos_l = pos_t.long()
        scale = Dh ** -0.5
        quant = self.kv_quant == "int8"
        if quant:
            kq, ks = state["kc_q"], state["kc_s"]
            vq, vs = state["vc_q"], state["vc_s"]
        else:
            kc, vc = state["kc"], state["vc"]
        ck, cv, src_bias = state["ck"], state["cv"], state["src_bias"]
        x = p["trg_emb.w_0"][ids_t] * float(np.sqrt(D)) + self._pe[pos_l]
        for i in range(L):
            res = x
            q = _fc(x, p[f"dec{i}_self_q.w_0"]).reshape(S, H, Dh)
            if quant:
                for codes, scales, w in ((kq, ks, "k"), (vq, vs, "v")):
                    self._write_int8(codes, scales, i, pos_l, _fc(
                        x, p[f"dec{i}_self_{w}.w_0"]))
                o = dequant_attend(q.contiguous(), kq[i], ks[i], vq[i],
                                   vs[i], pos_t, scale).reshape(S, D)
            else:
                kc[i, self._rows, pos_l] = _fc(
                    x, p[f"dec{i}_self_k.w_0"]).reshape(S, H, Dh)
                vc[i, self._rows, pos_l] = _fc(
                    x, p[f"dec{i}_self_v.w_0"]).reshape(S, H, Dh)
                o = decode_attend(q.contiguous(), kc[i], vc[i], pos_t,
                                  scale).reshape(S, D)
            x = self._norm(_fc(o, p[f"dec{i}_self_o.w_0"]) + res, "dec", i,
                           "self")
            res = x
            q = _fc(x, p[f"dec{i}_cross_q.w_0"]).reshape(S, 1, H, Dh)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, ck[i]).float() \
                * scale
            w = _attn_softmax(logits + src_bias).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", w, cv[i]).reshape(S, D)
            x = self._norm(_fc(o, p[f"dec{i}_cross_o.w_0"]) + res, "dec",
                           i, "cross")
            res = x
            h = _fc(x, p[f"dec{i}_ffn_fc1.w_0"], p[f"dec{i}_ffn_fc1.b_0"],
                    relu=True)
            h = _fc(h, p[f"dec{i}_ffn_fc2.w_0"], p[f"dec{i}_ffn_fc2.b_0"])
            x = self._norm(h + res, "dec", i, "ffn")
        logits = _fc(x, p["proj.w_0"])                        # [S, V]
        if self.topk > 1:
            vals, cand = torch.topk(logits, self.topk, dim=-1)
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            probs = torch.softmax(vals.float() / self.temperature, dim=-1)
            choice = torch.multinomial(probs, 1, generator=gen)
            nxt = cand.gather(-1, choice)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        if self.return_logits:
            self.last_logits = logits.float().cpu().numpy()
        return nxt.to(torch.int32).cpu().numpy()

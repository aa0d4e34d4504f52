"""Transformer-base NMT on PyTorch (counterpart of
`paddle_tpu/models/transformer.py`): the Program model built with the
port's layers (`transformer` :121, `encoder` :81, `decoder` :97, the
training graph `build_program` :135, `build_infer_program` :171 and
`greedy_decode` :189), and the
incremental (KV-cached) decoder (`TransformerConfig` :19,
`convert_qkv_checkpoint` :248, `_ln_index` :284, `decode_params` :296
and `IncrementalDecoder` :327 with the fp32 and the int8 cache).

The Program model runs through `core.executor.Executor`; on the card
its `layer_norm` and `flash_attention` ops launch the hand-written
kernels of `ops/kern/layer_norm.py` and `ops/kern/flash_attention.py`,
and in a training step (`build_program`, then `optimizer.Adam.minimize`)
their backward kernels too.

The JAX decoder jit-compiles one prefill per row bucket and one step
function and donates the cache buffers to them. The port runs eagerly:
the cache tensors are updated in place, which stands in for donation.
On the card the step's self-attention over the slot pool is a
hand-written CUDA kernel: `ops.kern.decode_attention.decode_attend`
over the fp32 cache, or `dequant_attend` over the int8 cache, whose
rows `ops.kern.quant.quantize_int8_blockwise` (a CUDA kernel too)
quantizes as they are written. On the CPU the same calls take their
plain versions. Weights arrive as numpy arrays (or tensors) in either
checkpoint layout through `params_from_numpy`, which keeps a bf16
checkpoint in bf16: the decoder then follows the reference
composition's dtypes op by op (JAX's promotions: bf16 where both sides
are bf16, f32 as soon as one is), and casts q to fp32 where it enters
the fp32 attention kernels. Two places differ from the reference with
a bf16 checkpoint, both in layer 0 of the step: the attention kernels
keep the softmax weights in f32 where the reference's composition
rounds them to bf16 before the weighted sum, and the int8 cache
quantizes the new K/V rows from their f32 values where the reference
quantizes them in bf16 arithmetic.
"""
import numpy as np
import torch

from .. import layers
from ..core import framework as _fw
from ..core.dtypes import tensor_from_numpy
from ..device import resolve_device
from ..ops.kern.decode_attention import decode_attend, dequant_attend
from ..ops.kern.quant import quantize_int8_blockwise
from ..ops.kernels_nn import _attn_softmax

__all__ = ["TransformerConfig", "transformer", "encoder", "decoder",
           "build_program", "build_infer_program", "greedy_decode",
           "convert_qkv_checkpoint", "param_shapes", "decode_params",
           "params_from_numpy", "IncrementalDecoder"]


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


def _pad_bias(seq_len, maxlen):
    """[B] lengths -> additive attention bias [B,1,1,T] (0 keep, -1e9
    pad)."""
    mask = layers.sequence_mask(seq_len, maxlen=maxlen, dtype="float32")
    bias = layers.scale(mask, scale=1e9, bias=-1e9)
    return layers.unsqueeze(bias, [1, 2])


def _embed(ids, vocab, cfg, name):
    emb = layers.embedding(ids, size=[vocab, cfg.d_model], name=name)
    emb = layers.scale(emb, scale=float(np.sqrt(cfg.d_model)))
    emb = layers.add_position_encoding(emb)
    if cfg.dropout:
        emb = layers.dropout(emb, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return emb


def _ffn(x, cfg, name):
    h = layers.fc(x, cfg.d_inner, num_flatten_dims=2, act="relu",
                  name=f"{name}_fc1")
    if cfg.dropout:
        h = layers.dropout(h, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, cfg.d_model, num_flatten_dims=2, name=f"{name}_fc2")


def _res_norm(x, residual, cfg):
    out = layers.elementwise_add(x, residual)
    return layers.layer_norm(out, begin_norm_axis=2)


def encoder(src_emb, src_bias, cfg):
    x = src_emb
    for i in range(cfg.n_layer):
        attn = layers.multi_head_attention(
            x, x, x, attn_bias=src_bias,
            d_key=cfg.d_model // cfg.n_head,
            d_value=cfg.d_model // cfg.n_head,
            d_model=cfg.d_model, n_head=cfg.n_head,
            dropout_rate=cfg.dropout, name=f"enc{i}",
            fused_qkv=cfg.fused_qkv)
        x = _res_norm(attn, x, cfg)
        ff = _ffn(x, cfg, f"enc{i}_ffn")
        x = _res_norm(ff, x, cfg)
    return x


def decoder(trg_emb, enc_out, trg_bias, src_bias, cfg):
    x = trg_emb
    for i in range(cfg.n_layer):
        self_attn = layers.multi_head_attention(
            x, x, x, attn_bias=trg_bias, causal=True,
            d_key=cfg.d_model // cfg.n_head,
            d_value=cfg.d_model // cfg.n_head,
            d_model=cfg.d_model, n_head=cfg.n_head,
            dropout_rate=cfg.dropout, name=f"dec{i}_self",
            fused_qkv=cfg.fused_qkv)
        x = _res_norm(self_attn, x, cfg)
        cross = layers.multi_head_attention(
            x, enc_out, enc_out, attn_bias=src_bias,
            d_key=cfg.d_model // cfg.n_head,
            d_value=cfg.d_model // cfg.n_head,
            d_model=cfg.d_model, n_head=cfg.n_head,
            dropout_rate=cfg.dropout, name=f"dec{i}_cross",
            fused_qkv=cfg.fused_qkv)
        x = _res_norm(cross, x, cfg)
        ff = _ffn(x, cfg, f"dec{i}_ffn")
        x = _res_norm(ff, x, cfg)
    return x


def transformer(src, src_len, trg, trg_len, cfg):
    """Returns per-position logits [B, T_trg, trg_vocab]."""
    T_src = int(src.shape[1])
    T_trg = int(trg.shape[1])
    src_bias = _pad_bias(src_len, T_src)
    trg_bias = _pad_bias(trg_len, T_trg)
    enc_in = _embed(src, cfg.src_vocab, cfg, "src_emb")
    enc_out = encoder(enc_in, src_bias, cfg)
    dec_in = _embed(trg, cfg.trg_vocab, cfg, "trg_emb")
    dec_out = decoder(dec_in, enc_out, trg_bias, src_bias, cfg)
    return layers.fc(dec_out, cfg.trg_vocab, num_flatten_dims=2,
                     bias_attr=False, name="proj")


def build_program(cfg=None, maxlen=None):
    """The training graph: declares the feeds (src, src_len, trg,
    trg_len, label) and returns (feeds, avg_cost, token_count), the
    label-smoothed CE summed over the live target positions divided by
    their count (at least 1). The reference's `use_noam`, `warmup` and
    `lr` arguments are accepted and ignored there, and are not ported."""
    cfg = cfg or TransformerConfig.base()
    T = maxlen or cfg.max_len
    src = layers.data("src", shape=[T], dtype="int64")
    src_len = layers.data("src_len", shape=[], dtype="int64",
                          append_batch_size=True)
    trg = layers.data("trg", shape=[T], dtype="int64")
    trg_len = layers.data("trg_len", shape=[], dtype="int64",
                          append_batch_size=True)
    label = layers.data("label", shape=[T], dtype="int64")
    logits = transformer(src, src_len, trg, trg_len, cfg)
    loss = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(label, [2]),
        smooth_epsilon=cfg.label_smooth_eps or 0.0)
    tmask = layers.sequence_mask(trg_len, maxlen=T, dtype="float32")
    loss = layers.squeeze(loss, [2]) if len(loss.shape) == 3 else loss
    masked = layers.elementwise_mul(loss, tmask)
    token_count = layers.reduce_sum(tmask)
    avg_cost = layers.elementwise_div(
        layers.reduce_sum(masked),
        layers.elementwise_max(token_count,
                               layers.fill_constant([], "float32", 1.0)))
    return [src, src_len, trg, trg_len, label], avg_cost, token_count


def build_infer_program(cfg=None, maxlen=None):
    """Inference graph (no labels, no loss): (feed names, logits
    [B,T,V]). Build it under a fresh `unique_name.guard` in a fresh
    program, so its parameter names are the training program's."""
    cfg = cfg or TransformerConfig.base()
    T = maxlen or cfg.max_len
    src = layers.data("src", shape=[T], dtype="int64")
    src_len = layers.data("src_len", shape=[], dtype="int64",
                          append_batch_size=True)
    trg = layers.data("trg", shape=[T], dtype="int64")
    trg_len = layers.data("trg_len", shape=[], dtype="int64",
                          append_batch_size=True)
    logits = transformer(src, src_len, trg, trg_len, cfg)
    return ["src", "src_len", "trg", "trg_len"], logits


def greedy_decode(exe, infer_program, logits_var, src, src_len, bos=0,
                  eos=None, fetch_argmax=False):
    """Autoregressive greedy decode through the inference program: the
    program runs T-1 times on [B, T] feeds, the argmax at step t-1 fed
    back as token t. Returns ids [B, T] (position 0 is `bos`); stops
    early once every row has emitted `eos`. T is src.shape[1] and must
    equal the maxlen the program was built with. fetch_argmax appends an
    in-graph arg_max over the vocab (once per program) and fetches the
    [B, T] ids instead of the [B, T, V] logits."""
    T = int(src.shape[1])
    B = src.shape[0]
    built_T = int(infer_program.global_block().vars["trg"].shape[-1])
    if built_T != T:
        raise ValueError(
            f"src length {T} != infer program's built length {built_T}; "
            f"rebuild build_infer_program(maxlen={T})")
    fetch_var = logits_var
    if fetch_argmax:
        fetch_var = getattr(infer_program, "_greedy_argmax_var", None)
        if fetch_var is None:
            with _fw.program_guard(infer_program):
                fetch_var = layers.argmax(logits_var, axis=-1)
            infer_program._greedy_argmax_var = fetch_var
    ids = np.zeros((B, T), dtype=np.int64)
    ids[:, 0] = bos
    done = np.zeros((B,), bool)
    for t in range(1, T):
        out = exe.run(infer_program,
                      feed={"src": src, "src_len": src_len, "trg": ids,
                            "trg_len": np.full((B,), t, np.int64)},
                      fetch_list=[fetch_var], is_test=True)
        if fetch_argmax:
            nxt = np.asarray(out[0])[:, t - 1]
        else:
            nxt = np.asarray(out[0])[:, t - 1, :].argmax(-1)
        ids[:, t] = nxt
        if eos is not None:
            done |= nxt == eos
            if done.all():
                break
    return ids


def convert_qkv_checkpoint(arrays, cfg, to_fused):
    """Convert a parameter dict between the UNFUSED (per-projection
    enc{i}_q.w_0 / _k / _v) and FUSED (enc{i}_qkv.w_0,
    dec{i}_cross_kv.w_0) checkpoint layouts, in either direction. The
    values may be numpy or jax arrays or tensors; every value of the
    returned dict is a tensor (a tensor stays on its device, an array is
    copied onto the CPU in its own dtype). Fusion order is [q | k | v]
    (or [k | v]) along the output axis."""
    out = {n: a if isinstance(a, torch.Tensor)
           else tensor_from_numpy(a, "cpu") for n, a in arrays.items()}

    def fuse(base, parts, fused_name):
        names = [f"{base}_{p}.w_0" for p in parts]
        if all(n in out for n in names):
            out[fused_name] = torch.cat([out.pop(n) for n in names], dim=1)

    def split(base, parts, fused_name):
        if fused_name in out:
            pieces = torch.chunk(out.pop(fused_name), len(parts), dim=1)
            out.update((f"{base}_{p}.w_0", piece)
                       for p, piece in zip(parts, pieces))

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
    """The JAX package's parameters as numpy arrays or tensors (either
    checkpoint layout) -> the port's {name: torch.Tensor} on `device`
    (the card unless ``"cpu"`` is passed): bf16 parameters stay bf16,
    as the reference keeps a checkpoint's dtype; every other one is
    fp32."""
    dev = resolve_device(device)
    out = {}
    for n, a in decode_params(arrays, cfg).items():
        t = tensor_from_numpy(a, dev)
        out[n] = t if t.dtype == torch.bfloat16 else t.float()
    return out


def _pe(T, D, device):
    """Sinusoidal position table [T, D] in f32, as the
    add_position_encoding kernel computes it."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _scalar(v, x):
    """The Python scalar v as a 0-d tensor in x's dtype: JAX's
    ``x * jnp.asarray(v, x.dtype)`` rounds v to bf16 first."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _ln(x, scale, bias, eps=1e-5):
    """Layer norm over the last axis with f32 internals."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.reshape(-1) + bias.reshape(-1)).to(x.dtype)


def _fc(x, w, b=None, relu=False):
    """Matmul over the flattened leading dims, + bias, + relu. Mixed bf16
    and f32 operands promote to f32, as in JAX."""
    lead = x.shape[:-1]
    dt = torch.promote_types(x.dtype, w.dtype)
    out = (x.reshape(-1, x.shape[-1]).to(dt) @ w.to(dt)).reshape(
        *lead, w.shape[1])
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
            shp = tuple(new[k].shape)
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
        x = p["src_emb.w_0"][ids]
        x = x * _scalar(np.sqrt(D), x) + self._pe[:Ts][None].to(x.dtype)
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
        state["ck"][:, idx] = ck[:, :n].to(state["ck"].dtype)
        state["cv"][:, idx] = cv[:, :n].to(state["cv"].dtype)
        state["src_bias"][idx] = src_bias[:n]
        return state

    def _write_int8(self, codes, scales, i, pos_l, new):
        """Quantize the new rows `new` [S, H*Dh] in kv_block-wide blocks
        and write their codes and scales at (layer i, slot, pos) in
        place (the reference's int8 `cache_write`)."""
        S, H = self.num_slots, self.cfg.n_head
        Dh = self.cfg.d_model // H
        q8, sc = quantize_int8_blockwise(new.reshape(-1).float(),
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
        x = p["trg_emb.w_0"][ids_t]
        x = x * _scalar(np.sqrt(D), x) + self._pe[pos_l].to(x.dtype)
        for i in range(L):
            res = x
            q = _fc(x, p[f"dec{i}_self_q.w_0"]).reshape(S, H, Dh)
            if quant:
                for codes, scales, w in ((kq, ks, "k"), (vq, vs, "v")):
                    self._write_int8(codes, scales, i, pos_l, _fc(
                        x, p[f"dec{i}_self_{w}.w_0"]))
                o = dequant_attend(q.float().contiguous(), kq[i], ks[i],
                                   vq[i], vs[i], pos_t, scale).reshape(S, D)
            else:
                kc[i, self._rows, pos_l] = _fc(
                    x, p[f"dec{i}_self_k.w_0"]).reshape(S, H, Dh).float()
                vc[i, self._rows, pos_l] = _fc(
                    x, p[f"dec{i}_self_v.w_0"]).reshape(S, H, Dh).float()
                o = decode_attend(q.float().contiguous(), kc[i], vc[i],
                                  pos_t, scale).reshape(S, D)
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

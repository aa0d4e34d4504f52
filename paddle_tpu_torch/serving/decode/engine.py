"""DecodeEngine: the serving face of the incremental decoder
(counterpart of `paddle_tpu/serving/decode/engine.py`, without the
disaggregated prefill device, the shared build cache, the memory ledger
and telemetry).

Wraps `models.transformer.IncrementalDecoder` with what the continuous
scheduler needs:

- **bucketed prefill**: admitted requests are padded row-wise to a fixed
  bucket set (powers of two up to `num_slots` by default, as
  `inference.default_buckets`), so prefill sees a bounded set of shapes;
- **warmup**: every prefill bucket and the step run once on zero feeds
  before traffic, which builds the step's CUDA kernels and initialises
  the libraries, so live requests never wait on them.

The scheduler talks to this class through a narrow, duck-typeable
surface (``num_slots / max_new_tokens / src_max_len / init_state /
warmup / admit / step``), so scheduler tests can use a fake engine.
"""
import numpy as np

from ...inference import default_buckets, next_bucket
from ...models.transformer import IncrementalDecoder

__all__ = ["DecodeEngineConfig", "DecodeEngine"]


class DecodeEngineConfig:
    """Knobs for one model's decode tier.

    num_slots: decode batch rows (the KV-cache's slot dimension).
    max_len: decode cache length (generated capacity = max_len - 1);
        defaults to the model config's max_len.
    src_max_len: encoder pad length; defaults to max_len.
    prefill_buckets: admitted-row buckets (default: powers of two up
        to num_slots).
    topk / temperature: sampling (0 = greedy argmax).
    kv_quant / kv_block: None keeps the fp32 self-attention cache;
        "int8" stores int8 codes with fp32 scales over kv_block-wide
        blocks of the head dim (default: the whole head), which shrinks
        `kv_cache_bytes` (see IncrementalDecoder).
    """

    def __init__(self, num_slots=8, max_len=None, src_max_len=None,
                 prefill_buckets=None, topk=0, temperature=1.0,
                 kv_quant=None, kv_block=None):
        self.num_slots = int(num_slots)
        self.max_len = max_len
        self.src_max_len = src_max_len
        self.prefill_buckets = tuple(sorted(
            int(b) for b in (prefill_buckets
                             or default_buckets(self.num_slots))))
        if self.prefill_buckets[-1] < self.num_slots:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} "
                f"< num_slots {self.num_slots}: a full admission wave "
                f"must fit one prefill")
        self.topk = int(topk)
        self.temperature = float(temperature)
        self.kv_quant = kv_quant
        self.kv_block = kv_block


class DecodeEngine:
    """Continuous-decode engine for one transformer on one device (the
    card unless ``device="cpu"`` is passed; raises without CUDA)."""

    def __init__(self, model_cfg, params, config=None, device=None):
        self.config = config or DecodeEngineConfig()
        self.decoder = IncrementalDecoder(
            model_cfg, params,
            num_slots=self.config.num_slots,
            max_len=self.config.max_len,
            src_max_len=self.config.src_max_len,
            topk=self.config.topk,
            temperature=self.config.temperature,
            device=device,
            kv_quant=self.config.kv_quant,
            kv_block=self.config.kv_block)
        self.device = self.decoder.device

    @classmethod
    def from_scope(cls, scope, model_cfg, config=None, names=None,
                   **kw):
        """Build from a scope: any object with `get` and `__contains__`,
        such as the port's `core.scope.Scope`, the reference's Scope or
        a ``{name: array}`` dict. Values may be numpy arrays, jax arrays
        or tensors, in either checkpoint layout. `names` defaults to
        every name decode could need in either layout; absent ones are
        skipped."""
        if names is None:
            names = [n for n in _decode_name_universe(model_cfg)
                     if n in scope]
        arrays = {n: scope.get(n) for n in names}
        return cls(model_cfg, arrays, config=config, **kw)

    # ------------------------------------------------------- properties
    @property
    def num_slots(self):
        return self.config.num_slots

    @property
    def max_new_tokens(self):
        return self.decoder.max_new_tokens

    @property
    def src_max_len(self):
        return self.decoder.src_max_len

    @property
    def kv_cache_bytes(self):
        """Slot-state footprint (see IncrementalDecoder.kv_cache_bytes)."""
        return self.decoder.kv_cache_bytes()

    # -------------------------------------------------------- lifecycle
    def init_state(self):
        return self.decoder.init_state()

    def set_params(self, arrays):
        """Rolling weight update: swap the parameter set (shapes must
        match)."""
        self.decoder.load_params(arrays)

    def warmup(self):
        """Run every prefill bucket and one step on zero feeds. Returns
        the number of warmup runs (len(prefill_buckets) + 1)."""
        Ts = self.decoder.src_max_len
        for b in self.config.prefill_buckets:
            self.decoder.prefill(np.zeros((b, Ts), np.int64),
                                 np.ones((b,), np.int64))
        self.decoder.step(self.init_state(),
                          np.zeros(self.num_slots, np.int64),
                          np.zeros(self.num_slots, np.int64))
        return len(self.config.prefill_buckets) + 1

    # ---------------------------------------------------------- serving
    def admit(self, state, requests, slots):
        """Prefill `requests` (same count as `slots`) and copy the
        encoder caches into their slot rows. Rows are padded to the next
        prefill bucket."""
        n = len(requests)
        Ts = self.decoder.src_max_len
        bucket = next_bucket(n, self.config.prefill_buckets)
        src = np.zeros((bucket, Ts), np.int64)
        src_len = np.ones((bucket,), np.int64)   # pad rows attend pos 0
        for j, r in enumerate(requests):
            s = np.asarray(r.src, np.int64).reshape(-1)
            src[j, :len(s)] = s
            src_len[j] = min(Ts, max(1, int(r.src_len)))
        out = self.decoder.prefill(src, src_len)
        return self.decoder.write_slots(state, out, slots)

    def step(self, state, ids, pos, seed=0):
        """One decode iteration over all slots -> next ids [S]."""
        return self.decoder.step(state, ids, pos, seed=seed)


def _decode_name_universe(cfg):
    """Every parameter name decode could need, in either checkpoint
    layout (union of unfused + fused names)."""
    names = ["src_emb.w_0", "trg_emb.w_0", "proj.w_0"]
    for i in range(cfg.n_layer):
        names += [f"enc{i}_{p}.w_0" for p in "qkvo"]
        names += [f"dec{i}_self_{p}.w_0" for p in "qkvo"]
        names += [f"dec{i}_cross_{p}.w_0" for p in "qkvo"]
        names += [f"enc{i}_qkv.w_0", f"dec{i}_self_qkv.w_0",
                  f"dec{i}_cross_kv.w_0", f"dec{i}_cross_q.w_0"]
        for part in (f"enc{i}_ffn", f"dec{i}_ffn"):
            names += [f"{part}_fc1.w_0", f"{part}_fc1.b_0",
                      f"{part}_fc2.w_0", f"{part}_fc2.b_0"]
    for j in range(5 * cfg.n_layer):
        names += [f"layer_norm_{j}.w_0", f"layer_norm_{j}.b_0"]
    return names

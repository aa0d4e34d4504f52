"""The sharded embedding engine (counterpart of
`paddle_tpu/parallel/sparse.py`: `SparsePolicy`, `parse_policy`,
`resolve_policy`, `discover_tables`, `unique_static` :180,
`_owner_buckets` :197, `_Axis`, `ShardedTable`, `strip_table_init` and
`SparseEngine` :276).

A program whose tables are built with `embedding(is_sparse=True,
is_distributed=True)` and run by `ParallelExecutor(sparse="shard")`
gets its lookups and their row-sparse updates from this engine:

- placement: a `ShardedTable` holds ceil(vocab / n) rows on each of the
  mesh's n members, mod-sharded (row r on member r % n at local row
  r // n); its row-shaped optimizer moments shard with it;
- dedup: each step the lookup's ids (clipped to the table) collapse
  through `unique_static` (a stable sort: uids padded with -1, inv with
  flat[i] == uids[inv[i]], the count kept on the device), so the
  exchange and the update move the distinct ids only;
- exchange: the distinct ids go to their owners in per-owner buckets of
  `cap` slots (`_owner_buckets`; ids past `cap` are dropped and
  counted), one all-to-all each way;
- local lookup: the fetched rows expand to the lookup's [..., D] output
  through the fused lookup kernel, `ops.kern.embedding.lookup_pool`
  (F = 1, sum: `csrc/embedding.cu` on the card, one launch per lookup),
  then the row-gradient tap and the padding mask, in the dense
  lookup's order;
- update: the tail's `sparse_sgd` / `sparse_adam` op merges its taps'
  row gradients (`kernels_optim.segment_sum_sorted`, a fixed-order
  segment sum), sends them to their owners, merges them again across
  members and applies the shared row formulas (`sgd_row_update`,
  `adam_row_update`) to the owned rows in place; with `stale=k` the
  update of step N is applied in step N + k from a ring of pending
  updates, and lookups read the table before it;
- `tpusparse.stats.<table>`: [ids looked up, distinct ids, ids dropped
  at `cap`, lookups] per member, summed over steps, a persistable of
  the engine (`state_entries`, `collect`).

The collective surface (`_Axis`) has one member: with n = 1,
`all_to_all` and `psum` are the identity, which is what
`lax.all_to_all` and `lax.psum` compute over a size-1 axis. A mesh of
more than one member raises NotImplementedError; the exchange over
`torch.distributed` is ROADMAP queue A 10. With one member the
reference's member mean of the row gradients (`reduce="mean"`) divides
by 1, and is left out.

`init_shards` seeds each table on the mesh's device with a
`torch.Generator` seeded from the caller's seed, a stable hash of the
table's name (`zlib.crc32`) and the member, so no host copy of a
[1e8, D] table is made and two processes draw the same rows. (The
reference seeds numpy from Python's `hash()` of the name, which changes
from one process to the next unless PYTHONHASHSEED is set.) Its rows
are N(0, scale) from PyTorch's generator, not the reference's numpy
draws; a table carried over from the reference comes through
`to_logical` on its side and `scope_from_numpy` + `prepare_persist`
(or `install_shards`) here, and leaves through `to_logical` or
`export_shards`.

The policy grammar is the reference's, `shard[:stale=K,cap=N,
kernel=0/1]` or `PADDLE_TPU_SPARSE`; `kernel=0`, which turned the
reference's Pallas lookup off, is parsed and then refused: the port has
no switch that turns a kernel off. Not ported: `key`, `probe_clone`
and `out_spec` (jit and shard_map plumbing), `update_gauges` and the
telemetry counters (ROADMAP queue A 11).
"""
import os
import re
import zlib

import numpy as np
import torch

from ..core.dtypes import tensor_from_numpy, to_torch_dtype
from ..ops.kernels_optim import (adam_row_update, dedup_rows,
                                 segment_sum_sorted, set_rows_,
                                 sgd_row_update)
from ..ops.kern.embedding import lookup_pool

__all__ = ["SparsePolicy", "parse_policy", "resolve_policy",
           "discover_tables", "unique_static", "SparseEngine",
           "ShardedTable", "strip_table_init", "STATS_PREFIX",
           "PEND_PREFIX"]

ENV_VAR = "PADDLE_TPU_SPARSE"
STATS_PREFIX = "tpusparse.stats."
PEND_PREFIX = "tpusparse.pend."

# accumulator kinds of the optimizers' row-shaped state (optimizer.py
# _add_accumulator), matched as the reference matches them
_ACCUM_KINDS = ("moment1", "moment2", "moment", "velocity", "inf_norm",
                "mean_square", "mean_grad", "squared", "linear",
                "avg_squared_grad", "avg_squared_update")


class SparsePolicy:
    """One resolved engine policy: `stale_steps=k` applies each step's
    row updates k steps later; `capacity` caps the per-owner exchange
    buckets (None: the worst case, nothing dropped)."""

    def __init__(self, mode="shard", stale_steps=0, capacity=None,
                 kernel=True, axis_name="dp"):
        if mode != "shard":
            raise ValueError(f"sparse mode {mode!r} not in ('shard',)")
        if stale_steps < 0:
            raise ValueError("sparse stale_steps must be >= 0")
        if capacity is not None and capacity < 1:
            raise ValueError("sparse cap must be >= 1")
        if not kernel:
            raise NotImplementedError(
                "sparse kernel=0 turned the reference's Pallas lookup off; "
                "the port has no switch that turns a kernel off")
        self.mode = mode
        self.stale_steps = int(stale_steps)
        self.capacity = None if capacity is None else int(capacity)
        self.axis_name = axis_name

    def __repr__(self):
        return (f"SparsePolicy(mode={self.mode!r}, "
                f"stale_steps={self.stale_steps}, "
                f"capacity={self.capacity})")


def parse_policy(spec):
    """`spec` -> SparsePolicy, or None for off. Grammar:
    `shard[:stale=K,cap=N,kernel=0/1]`; "on" / "1" mean "shard"."""
    if spec is None or isinstance(spec, SparsePolicy):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "0", "off", "none", "false"):
        return None
    if s in ("1", "on", "true"):
        s = "shard"
    mode, _, opts = s.partition(":")
    kw = {}
    for item in filter(None, (t.strip() for t in opts.split(","))):
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(f"sparse option {item!r} is not k=v")
        if k in ("stale", "stale_steps"):
            kw["stale_steps"] = int(v)
        elif k in ("cap", "capacity"):
            kw["capacity"] = int(v)
        elif k == "kernel":
            kw["kernel"] = v not in ("0", "false", "off")
        else:
            raise ValueError(f"unknown sparse option {k!r}")
    return SparsePolicy(mode=mode, **kw)


def resolve_policy(arg=None):
    """An explicit arg (including "off") beats PADDLE_TPU_SPARSE."""
    if arg is not None:
        return parse_policy(arg)
    env = os.environ.get(ENV_VAR)
    if env is not None and env.strip():
        return parse_policy(env)
    return None


def discover_tables(program):
    """The distributed lookup tables of `program`, sorted; every lookup
    on such a table must be distributed."""
    ops = [op for op in program.global_block().ops
           if op.type == "lookup_table"]
    dist = {op.inputs["W"][0] for op in ops
            if op.attrs.get("is_distributed")}
    for op in ops:
        if op.inputs["W"][0] in dist and not op.attrs.get("is_distributed"):
            raise RuntimeError(
                "lookup_table_ops on the same table must all be "
                "distributed")
    return sorted(dist)


def unique_static(flat_ids):
    """Dedup with a static shape: flat_ids [M] (all >= 0) -> (uids [M],
    inv [M], count 0-d), int64: uids[:count] are the distinct ids
    ascending, uids[count:] == -1, flat_ids[i] == uids[inv[i]]. The sort
    is stable, so inv is the reference's exactly."""
    flat = flat_ids.reshape(-1).long()
    sid, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    uids = torch.full_like(sid, -1).scatter_(0, seg, sid)
    inv = torch.empty_like(seg).scatter_(0, order, seg)
    return uids, inv, seg[-1] + 1


def _scatter_drop(shape, fill, flat_at, ok, values):
    """A tensor of `shape` filled with `fill`, values[i] written at
    position flat_at[i] of its first two dims flattened where ok[i]
    (distinct there); the others go to a scratch row cut off at the
    end."""
    n = shape[0] * shape[1]
    buf = torch.full((n + 1,) + tuple(shape[2:]), fill, dtype=values.dtype,
                     device=values.device)
    buf.index_copy_(0, torch.where(ok, flat_at, n), values)
    return buf[:n].reshape(shape)


def _owner_buckets(uids, n, cap):
    """Route distinct ids to their mod-sharding owners: uids [M] (-1
    padded) -> (req [n, cap] (-1 padded), owner [M], pos [M], overflow
    0-d). Entry i goes to bucket owner[i] = uids[i] % n at slot pos[i],
    its rank in the bucket; entries past `cap` are dropped and
    counted."""
    valid = uids >= 0
    owner = torch.where(valid, uids % n, n)
    # [n + 1, M] so the running count is an innermost-dim scan: over
    # [M, n + 1], dim 0, PyTorch's CUDA scan took ~1.2 ms a call on an
    # H100 at M = 13312 (chip_smoke.py's engine profile)
    onehot = (torch.arange(n + 1, device=uids.device)[:, None]
              == owner[None, :]).long()
    pos = (torch.cumsum(onehot, 1) - 1).gather(0, owner[None, :])[0]
    overflow = ((pos >= cap) & valid).sum()
    ok = valid & (pos < cap)
    req = _scatter_drop((n, cap), -1, owner * cap + pos, ok,
                        torch.where(valid, uids, -1))
    return req, owner, pos, overflow


class _Axis:
    """The engine's collectives over its mesh axis, for one member:
    `all_to_all` and `psum` over a size-1 axis are the identity."""

    def __init__(self, name, size):
        if size != 1:
            raise NotImplementedError(
                f"the sparse engine runs on a one-member mesh; a {name!r} "
                f"axis of {size} members needs the torch.distributed "
                f"exchange (ROADMAP queue A 10)")
        self.name = name
        self.size = 1

    def all_to_all(self, x):
        return x

    def psum(self, x):
        return x


class ShardedTable:
    """The static description and per-run plan of one mod-sharded
    table."""

    def __init__(self, name, vocab, dim, dtype, n):
        self.name = name
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = dtype
        self.n = int(n)
        self.local_rows = -(-self.vocab // self.n)
        self.moments = {}          # accumulator var name -> itself
        self.m_ids = None          # ids a member looks up a step (plan)
        self.cap = None            # per-owner exchange capacity (plan)

    @property
    def physical_shape(self):
        return (self.n * self.local_rows, self.dim)

    @property
    def stats_name(self):
        return STATS_PREFIX + self.name

    def pend_names(self):
        return (PEND_PREFIX + self.name + ".ids",
                PEND_PREFIX + self.name + ".g")


def strip_table_init(startup_program, names):
    """Remove `names`' initializer ops (and variables) from a startup
    program, so tables too big to build whole are never made there:
    pair with `SparseEngine.init_shards`."""
    names = set(names)
    blk = startup_program.global_block()
    blk.ops[:] = [op for op in blk.ops
                  if not (set(op.output_names()) & names)]
    for n in names:
        blk.vars.pop(n, None)
    startup_program._bump_version()
    return startup_program


def _stable_hash(name):
    return zlib.crc32(name.encode("utf-8"))


class SparseEngine:
    """The engine `ParallelExecutor(sparse=...)` attaches to a program
    with distributed tables: `exec` runs the lookup_table and
    sparse_sgd / sparse_adam ops it `owns` inside the step
    (core/trace.py `build_step_fn(sparse_engine=...)`)."""

    def __init__(self, program, policy, mesh, table_names=None):
        self.program = program
        self.policy = policy
        self.mesh = mesh
        axis = policy.axis_name
        if axis not in mesh.shape:
            raise ValueError(
                f"sparse engine needs a {axis!r} axis on the mesh")
        self.n = int(mesh.shape[axis])
        self.axis = _Axis(axis, self.n)
        self.device = mesh.devices[0]
        names = table_names if table_names is not None \
            else discover_tables(program)
        if not names:
            raise ValueError(
                "sparse engine: program has no distributed lookup "
                "table (embedding(..., is_distributed=True))")
        block = program.global_block()
        self.tables = {}
        for name in names:
            var = block.vars.get(name)
            if var is None or len(var.shape or ()) < 2:
                raise ValueError(
                    f"sparse engine: table {name!r} not a [vocab, dim] "
                    "var in the program")
            self.tables[name] = ShardedTable(
                name, var.shape[0], var.shape[-1],
                str(var.dtype or "float32"), self.n)
        for op in block.ops:
            if op.type == "lookup_table" and \
                    op.inputs["W"][0] in self.tables and \
                    not op.attrs.get("is_sparse"):
                raise ValueError(
                    f"sparse engine: distributed table "
                    f"{op.inputs['W'][0]!r} must use "
                    "embedding(is_sparse=True) — the engine applies "
                    "row-sparse updates through the SparseDelta taps")
            if op.attrs.get("is_optimizer_op") and \
                    op.inputs.get("Param") and \
                    op.inputs["Param"][0] in self.tables and \
                    op.type not in ("sparse_sgd", "sparse_adam"):
                raise NotImplementedError(
                    f"sparse engine: {op.type!r} update on sharded "
                    f"table {op.inputs['Param'][0]!r}; use Adam or SGD")
        accum_re = {
            t: re.compile(re.escape(t) + "_(" + "|".join(_ACCUM_KINDS)
                          + r")_\d+$")
            for t in self.tables}
        for v in program.persistable_vars():
            for t, rx in accum_re.items():
                spec = self.tables[t]
                if rx.fullmatch(v.name) and \
                        tuple(v.shape) == (spec.vocab, spec.dim):
                    spec.moments[v.name] = v.name
        self._physical = set()      # names holding this engine's layout

    @property
    def row_var_names(self):
        """Every persistable the engine stores mod-sharded: the tables
        and their row-shaped accumulators."""
        out = []
        for t in self.tables.values():
            out.append(t.name)
            out.extend(t.moments)
        return out

    def owner_table(self, name):
        """The ShardedTable a row var belongs to, or None."""
        for t in self.tables.values():
            if name == t.name or name in t.moments:
                return t
        return None

    # ------------------------------------------------------ placement
    def to_physical(self, t, logical):
        """A logical [V, D] tensor -> the mod layout [n * L, D] on its
        device (physical row d * L + l holds logical row l * n + d; pad
        rows zero)."""
        if isinstance(t, str):
            t = self.tables[t]
        p = torch.arange(t.n * t.local_rows, device=logical.device)
        lg = (p % t.local_rows) * t.n + p // t.local_rows
        out = logical[lg.clamp(max=t.vocab - 1)]
        return torch.where((lg < t.vocab)[:, None], out,
                           torch.zeros_like(out))

    def to_logical(self, t, physical):
        """The mod layout -> logical [V, D] on the host (numpy): a
        table's or moment's value read back for tests and checkpoints."""
        if isinstance(t, str):
            t = self.owner_table(t)
        if isinstance(physical, torch.Tensor):
            physical = physical.detach().cpu().numpy()
        physical = np.asarray(physical)
        r = np.arange(t.vocab)
        return physical[(r % t.n) * t.local_rows + r // t.n]

    def prepare_persist(self, persist, scope):
        """Place every engine row var into `persist`, on the mesh's
        device: values in the logical layout (the startup program's, a
        reference's `to_logical` export loaded with `scope_from_numpy`)
        are permuted to the mod layout once and written back to the
        scope; values this engine laid out (`init_shards`,
        `install_shards`, a previous run) pass untouched."""
        for t in self.tables.values():
            for name in [t.name] + list(t.moments):
                val = scope.get(name)
                if val is None:
                    raise RuntimeError(
                        f"sharded table var {name!r} not initialized; "
                        "run the startup program, or for tables too big "
                        "to build whole use sparse.strip_table_init + "
                        "engine.init_shards")
                physical = (name in self._physical
                            and isinstance(val, torch.Tensor)
                            and tuple(val.shape) == t.physical_shape)
                if not physical:
                    if not isinstance(val, torch.Tensor):
                        val = tensor_from_numpy(np.asarray(val),
                                                self.device)
                    val = self.to_physical(t, val.to(self.device))
                    scope.set(name, val)
                    self._physical.add(name)
                persist[name] = val

    def install_shards(self, scope, name, make_rows):
        """Install one engine row var member by member: `make_rows(d)`
        returns member d's [local_rows, dim] rows in the mod layout
        (local row l holds logical id l * n + d), as a tensor or a
        numpy array; the var is built on the mesh's device and marked
        as laid out."""
        t = self.owner_table(name)
        if t is None:
            raise KeyError(
                f"install_shards: {name!r} is not an engine row var")
        L = t.local_rows
        dtype = to_torch_dtype(t.dtype)
        parts = []
        for d in range(t.n):
            rows = make_rows(d)
            if tuple(rows.shape) != (L, t.dim):
                raise ValueError(
                    f"install_shards({name!r}): shard builder returned "
                    f"{tuple(rows.shape)}, want {(L, t.dim)}")
            if not isinstance(rows, torch.Tensor):
                rows = torch.tensor(np.asarray(rows))     # a copy
            parts.append(rows.to(self.device, dtype).contiguous())
        # one member: its rows are the table, with no second copy
        arr = parts[0] if t.n == 1 else torch.cat(parts)
        scope.set(name, arr)
        self._physical.add(name)

    def init_shards(self, scope, seed=0, scale=0.02):
        """Seed every engine table member by member on the device:
        N(0, scale) rows from a torch.Generator seeded from (seed, a
        stable hash of the table's name, the member); rows past the
        vocab and the moments zero. Pair with `strip_table_init`."""
        for t in self.tables.values():

            def mk(d, _t=t):
                g = torch.Generator(device=self.device)
                g.manual_seed((seed * 131071 + _stable_hash(_t.name)
                               % 65521 + d) % (2 ** 31 - 1))
                rows = torch.empty((_t.local_rows, _t.dim),
                                   dtype=to_torch_dtype(_t.dtype),
                                   device=self.device)
                rows.normal_(0.0, scale, generator=g)
                first_pad = -(-(_t.vocab - d) // _t.n)
                rows[first_pad:] = 0
                return rows

            self.install_shards(scope, t.name, mk)
            for m in t.moments:
                self.install_shards(
                    scope, m, lambda d, _t=t: torch.zeros(
                        (_t.local_rows, _t.dim),
                        dtype=to_torch_dtype(_t.dtype), device=self.device))

    def export_shards(self, scope):
        """Host copies of every engine row var in the mod layout, one
        numpy array per member: (layout {name: manifest record}, files
        {file name: rows}). Row vars not yet laid out by the engine are
        left out; the caller saves those like any dense persistable."""
        layout, files = {}, {}
        for t in self.tables.values():
            for name in [t.name] + list(t.moments):
                val = scope.get(name)
                if not (name in self._physical
                        and isinstance(val, torch.Tensor)
                        and tuple(val.shape) == t.physical_shape):
                    continue
                safe = name.replace("/", "__")
                rec = {"kind": "mod_shard", "world": t.n,
                       "vocab": t.vocab, "dim": t.dim,
                       "local_rows": t.local_rows,
                       "dtype": str(val.dtype).replace("torch.", ""),
                       "files": {}}
                host = val.detach().cpu().numpy()
                for d in range(t.n):
                    fn = f"{safe}.shard{d}of{t.n}.npy"
                    rec["files"][str(d)] = fn
                    files[fn] = np.array(
                        host[d * t.local_rows:(d + 1) * t.local_rows])
                layout[name] = rec
        return layout, files

    # ------------------------------------------------------ run plan
    def plan_run(self, feed_shapes):
        """Per table, for this feed signature: m_ids (ids a member looks
        up a step over all the table's lookups) and the per-owner
        exchange capacity. Every lookup's Ids must be a feed."""
        block = self.program.global_block()
        for t in self.tables.values():
            m = 0
            for op in block.ops:
                if op.type != "lookup_table" or op.inputs["W"][0] != t.name:
                    continue
                ids_name = op.inputs["Ids"][0]
                shape = feed_shapes.get(ids_name)
                if shape is None:
                    raise ValueError(
                        f"sparse engine: lookup ids {ids_name!r} for "
                        f"table {t.name!r} is not a feed; feed the ids "
                        "directly (derived-id programs are not "
                        "supported by the sharded engine)")
                shape = tuple(shape)
                if shape and shape[-1] == 1:
                    shape = shape[:-1]
                m += int(np.prod(shape, dtype=np.int64))
            t.m_ids = m
            t.cap = min(self.policy.capacity or m, m)

    def state_entries(self):
        """[(name, shape, torch dtype, fill)] of the engine's own
        persistables: each table's stats accumulator, and with
        stale_steps > 0 its ring of pending updates (ids -1 = empty)."""
        out = []
        k = self.policy.stale_steps
        for t in self.tables.values():
            out.append((t.stats_name, (4,), torch.float32, 0.0))
            if k > 0:
                pid, pg = t.pend_names()
                out.append((pid, (self.n, k, t.m_ids), torch.int64, -1))
                out.append((pg, (self.n, k, t.m_ids, t.dim), torch.float32,
                            0.0))
        return out

    @property
    def state_names(self):
        return [e[0] for e in self.state_entries()]

    # ------------------------------------------------------ step ops
    def owns(self, op):
        if op.type == "lookup_table":
            return op.inputs["W"][0] in self.tables
        if op.type in ("sparse_sgd", "sparse_adam"):
            return op.inputs["Param"][0] in self.tables
        return False

    def exec(self, env, op):
        if op.type == "lookup_table":
            self._exec_lookup(env, op)
        else:
            self._exec_update(env, op)

    def _bump_stats(self, env, t, n_ids, n_unique, overflow, lookups):
        """Add [ids, distinct ids, overflow, lookups] (the member mean
        of a psum, over one member) to the table's stats."""
        upd = torch.stack([overflow.new_full((), n_ids), n_unique,
                           overflow, overflow.new_full((), lookups)])
        prev = env.get(t.stats_name)
        upd = self.axis.psum(upd).float()
        env[t.stats_name] = upd if prev is None else prev + upd

    def _exchange_rows(self, t, shard, uids):
        """One all-to-all round trip: distinct uids [M] (-1 padded) ->
        their rows [M, D] from the owners' shards, and the overflow."""
        n, cap = self.n, t.cap
        req, owner, pos, overflow = _owner_buckets(uids, n, cap)
        recv = self.axis.all_to_all(req)
        valid_r = recv >= 0
        lidx = torch.where(valid_r, recv // n, 0).clamp(0, t.local_rows - 1)
        rows = shard[lidx]
        rows = torch.where(valid_r[..., None], rows, torch.zeros_like(rows))
        got = self.axis.all_to_all(rows)
        ok = (uids >= 0) & (pos < cap)
        u_rows = got[owner.clamp(0, n - 1), pos.clamp(0, cap - 1)]
        u_rows = torch.where(ok[:, None], u_rows, torch.zeros_like(u_rows))
        return u_rows, overflow

    def _exec_lookup(self, env, op):
        """The distributed lookup: dedup -> row exchange -> the fused
        local lookup (+ the is_sparse delta tap, then the padding mask,
        in the dense kernel's order)."""
        t = self.tables[op.inputs["W"][0]]
        shard = env[t.name]
        ids = env[op.inputs["Ids"][0]]
        if ids.dim() >= 1 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        clipped = ids.long().clamp(0, t.vocab - 1)
        uids, inv, count = unique_static(clipped.reshape(-1))
        u_rows, overflow = self._exchange_rows(t, shard, uids)
        out = lookup_pool(u_rows, inv[:, None]).reshape(tuple(ids.shape) + (t.dim,))
        if op.inputs.get("SparseDelta"):
            out = out + env[op.inputs["SparseDelta"][0]]
        padding_idx = op.attrs.get("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((ids == padding_idx)[..., None],
                              torch.zeros_like(out), out)
        env[op.outputs["Out"][0]] = out
        self._bump_stats(env, t, inv.shape[0], count, overflow, 1)

    def _exec_update(self, env, op):
        """The table's sparse_sgd / sparse_adam: merge the taps' row
        gradients, then apply them now (stale=0) or push them onto the
        ring and apply the one pushed k steps ago."""
        t = self.tables[op.inputs["Param"][0]]
        ids = torch.cat([env[n].reshape(-1) for n in op.inputs["Ids"]])
        grads = torch.cat([env[n].reshape(-1, t.dim)
                           for n in op.inputs["Grad"]])
        uids, gsum = dedup_rows(ids, grads, t.vocab)
        uids = torch.where(uids < t.vocab, uids, -1)
        k = self.policy.stale_steps
        if k == 0:
            self._exchange_apply(env, op, t, uids, gsum)
            return
        pid, pg = t.pend_names()
        pend_i, pend_g = env[pid], env[pg]
        self._exchange_apply(env, op, t, pend_i[0, 0], pend_g[0, 0])
        env[pid] = torch.cat([pend_i[:, 1:], uids[None, None]], dim=1)
        env[pg] = torch.cat([pend_g[:, 1:], gsum[None, None]], dim=1)

    def _exchange_apply(self, env, op, t, uids, gsum):
        """Route the merged row gradients to their owners (one
        all-to-all pair), merge the same row's gradients from several
        members, and apply the shared row formulas to the owned rows in
        place; writes the op's outputs into env."""
        n, cap, D, L = self.n, t.cap, t.dim, t.local_rows
        req, owner, pos, overflow = _owner_buckets(uids, n, cap)
        ok = (uids >= 0) & (pos < cap)
        gbuf = _scatter_drop((n, cap, D), 0.0, owner * cap + pos, ok,
                             gsum.float())
        rid = self.axis.all_to_all(req).reshape(-1)
        rg = self.axis.all_to_all(gbuf).reshape(-1, D)
        key_ids = torch.where(rid >= 0, rid // n, L)
        ulidx, merged, _count = segment_sum_sorted(key_ids, rg, L)
        count = (ulidx < L).sum()
        safe = ulidx.clamp(max=L - 1)
        shard = env[t.name]
        lr = env[op.inputs["LearningRate"][0]].float().reshape(())
        if op.type == "sparse_sgd":
            new = sgd_row_update(shard.index_select(0, safe), merged, lr)
            env[op.outputs["ParamOut"][0]] = set_rows_(shard, ulidx, new,
                                                       count)
        else:
            a = op.attrs
            m = env[op.inputs["Moment1"][0]]
            v = env[op.inputs["Moment2"][0]]
            b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
            b1p_new = env[op.inputs["Beta1Pow"][0]] * b1
            b2p_new = env[op.inputs["Beta2Pow"][0]] * b2
            p_new, m_new, v_new = adam_row_update(
                shard.index_select(0, safe), m.index_select(0, safe),
                v.index_select(0, safe), merged, lr, b1, b2,
                a.get("epsilon", 1e-8), b1p_new, b2p_new)
            env[op.outputs["ParamOut"][0]] = set_rows_(shard, ulidx, p_new,
                                                       count)
            env[op.outputs["Moment1Out"][0]] = set_rows_(m, ulidx, m_new,
                                                         count)
            env[op.outputs["Moment2Out"][0]] = set_rows_(v, ulidx, v_new,
                                                         count)
            env[op.outputs["Beta1PowOut"][0]] = b1p_new
            env[op.outputs["Beta2PowOut"][0]] = b2p_new
        if t.stats_name in env:
            self._bump_stats(env, t, 0, overflow.new_zeros(()), overflow, 0)

    def collect(self, env):
        """The engine's own persistables in env (stats, rings)."""
        return {n: env[n] for n in self.state_names if n in env}

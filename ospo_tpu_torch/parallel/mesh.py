"""Tensor-parallel layout over processes — counterpart of
``ospo_tpu/parallel/mesh.py``.

The JAX package lays one ``Mesh(('data', 'model'))`` over the chips of a
process and lets GSPMD insert the collectives.  Here each process drives
one card, so the mesh is a grid of processes: the world's ranks are ordered
as JAX orders devices (``reshape(n // mp, mp)``), a rank's model index is
``rank % mp`` and its data index ``rank // mp``.  The ranks of one data
index form a *model group*: they hold one shard each of the same model and
serve the same work; the ranks of one model index form a *data group*.

- **TP**: the Llama projections are Megatron-style (qkv, gate and up
  column-parallel, o and down row-parallel; ``embed``, ``lm_head`` and
  ``gen_head.head`` vocab-parallel).  A rank keeps its contiguous shard
  (:func:`shard_janus_params`); ``models/llama.forward`` runs its own heads
  and FFN columns and all-reduces after ``wo`` and ``w_down``;
  ``models/janus`` all-gathers the vocab slices of the logits.  Autograd
  sees the collectives as Megatron's pair: the sum after a row-parallel
  product (:func:`all_reduce_model`) is the identity backward, and the
  replicated input of a column-parallel branch passes
  :func:`copy_to_model`, whose backward sums the input gradient over the
  group; the logits gather hands each rank its slice of the gradient.
- **DP**: work lists split by data index (``io.shard_for_process``).

The spec functions keep the JAX package's names and rules; a spec is the
index of the sharded axis, or None (replicated), in place of a
``PartitionSpec``.  ViT, VQ and the aligners are replicated.
"""

from __future__ import annotations

import dataclasses
import datetime
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ospo_tpu_torch.ops.quant import INT4_GROUP, _pack_halves, unpack_int4_halves

DATA_AXIS = "data"
MODEL_AXIS = "model"

# seconds a collective of a model group may wait before the run fails (a
# rank that took another host branch leaves its peers waiting forever)
TIMEOUT_S = 180.0

# this process's mesh: a process is one rank of one world, as its process
# group is (the counterpart of JAX's ``with mesh:``)
_CURRENT: Optional["Mesh"] = None
# the tensors shard_janus_params cut on their vocab axis (embed, lm_head,
# gen_head.head), by id; a weak value so a freed tensor's id is not reused
_VOCAB_SHARDS: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()


@dataclasses.dataclass
class Mesh:
    """This process's place in the (data, model) grid and its groups.
    Without a process group the mesh is one rank and every collective is
    the identity."""

    data: int
    model: int
    rank: int
    model_group: Any = None     # the ranks of this data index
    object_group: Any = None    # the same ranks on gloo, for host objects
    data_group: Any = None      # the ranks of this model index

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_src(self) -> int:
        """The global rank of model rank 0 in this rank's model group."""
        return self.data_index * self.model


def create_mesh(model_parallel: Optional[int] = None) -> Mesh:
    """Lay the world's ranks out as ``[world // mp, mp]`` and make the
    groups (every rank makes every group, in the same order, as
    ``dist.new_group`` requires); the mesh becomes this process's
    (:func:`current_mesh`).  A group's collectives fail after
    ``TIMEOUT_S``."""
    global _CURRENT
    import torch.distributed as dist

    mp = int(model_parallel or 1)
    if not (dist.is_available() and dist.is_initialized()):
        if mp != 1:
            raise ValueError(
                f"model_parallel={mp} needs {mp} processes: start them with "
                "scripts/run_multihost_torch.sh")
        _CURRENT = Mesh(data=1, model=1, rank=0)
        return _CURRENT
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % mp:
        raise ValueError(f"model_parallel={mp} does not divide the world of "
                         f"{world} processes")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    mesh = Mesh(data=world // mp, model=mp, rank=rank)
    for d in range(world // mp):
        ranks = list(range(d * mp, (d + 1) * mp))
        group = dist.new_group(ranks, timeout=timeout)
        # host flags travel on a group of their own, so that a rank that
        # failed out of a model collective cannot meet its peers' pending
        # one there
        objects = dist.new_group(ranks, timeout=timeout, backend="gloo")
        if d == mesh.data_index:
            mesh.model_group, mesh.object_group = group, objects
    for m in range(mp):
        group = dist.new_group(list(range(m, world, mp)), timeout=timeout)
        if m == mesh.model_rank:
            mesh.data_group = group
    _CURRENT = mesh
    return mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT


def model_parallel_size() -> int:
    return _CURRENT.model if _CURRENT is not None else 1


def model_rank() -> int:
    """This rank's index in its model group (0 without a mesh): only model
    rank 0 writes a group's files and contributes its records."""
    return _CURRENT.model_rank if _CURRENT is not None else 0


def _model_mesh(what: str) -> Mesh:
    if _CURRENT is None or _CURRENT.model == 1:
        raise RuntimeError(f"{what} holds a tensor-parallel shard but this "
                           "process has no model group (parallel.mesh."
                           "create_mesh)")
    return _CURRENT


# ---------------------------------------------------------------------------
# collectives of the model group (identity at one rank)
# ---------------------------------------------------------------------------


def _sum_model(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    mesh = _model_mesh("all_reduce_model")
    buf = x.float().contiguous() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(buf, group=mesh.model_group)
    return buf.to(x.dtype)


def _gather_last(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    mesh = _model_mesh("all_gather_last")
    n = x.shape[-1]
    out = torch.zeros((*x.shape[:-1], n * mesh.model), dtype=x.dtype,
                      device=x.device)
    out[..., mesh.model_rank * n:(mesh.model_rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.model_group)
    return out


class _SumModel(torch.autograd.Function):
    """g: the sum over the model group forward; its output is the same on
    every rank, so is the gradient that reaches it, which passes through."""

    @staticmethod
    def forward(ctx, x):
        return _sum_model(x)

    @staticmethod
    def backward(ctx, dy):
        return dy


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; the input gradient is each rank's partial
    (its heads, FFN columns or vocab slice) and is summed backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum_model(dy)


class _GatherLast(torch.autograd.Function):
    """The vocab slices joined forward; backward each rank keeps the
    gradient of its own slice."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return _gather_last(x)

    @staticmethod
    def backward(ctx, dy):
        k = _CURRENT.model_rank
        return dy[..., k * ctx.n:(k + 1) * ctx.n].contiguous()


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x``, summed in fp32 and returned in
    x's dtype (the row-parallel partial products, the vocab-parallel
    embedding); under autograd the gradient passes through unchanged."""
    return _SumModel.apply(x)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the model group (fp32)
    in the backward: the replicated input of a column-parallel or
    vocab-parallel product."""
    return _CopyToModel.apply(x)


def all_max_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every model rank's fp32 ``x`` (w8a8's
    per-token abs-max over a row-parallel input, an int8 row's weight
    abs-max over its columns)."""
    import torch.distributed as dist

    mesh = _model_mesh("all_max_model")
    buf = x.float().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return buf


def all_gather_last(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every model rank's ``x`` on the last axis, in rank order
    (vocab slices of logits).  Each rank places its slice in a zero buffer
    and the buffers are summed: exact, and one collective that gloo also
    runs on CUDA tensors.  Under autograd each rank's gradient is its
    slice of the joined one."""
    return _GatherLast.apply(x)


def broadcast_model(x: torch.Tensor) -> torch.Tensor:
    """Model rank 0's ``x`` on every rank of the group (sampled ids, host
    decisions), in place; the identity without a model group."""
    import torch.distributed as dist

    if _CURRENT is None or _CURRENT.model == 1:
        return x
    dist.broadcast(x, src=_CURRENT.model_src, group=_CURRENT.model_group)
    return x


def any_model(flag: bool) -> bool:
    """True on every rank of the group when ``flag`` is true on any (an OOM
    retry, a per-image retry), so all take the same branch."""
    import torch.distributed as dist

    if _CURRENT is None or _CURRENT.model == 1:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CURRENT.object_group)
    return bool(t.item())


def broadcast_object(obj: Any) -> Any:
    """Model rank 0's host object on every rank of the group."""
    import torch.distributed as dist

    if _CURRENT is None or _CURRENT.model == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_CURRENT.model_src,
                               group=_CURRENT.object_group)
    return box[0]


def is_vocab_shard(t: torch.Tensor) -> bool:
    return _VOCAB_SHARDS.get(id(t)) is t


def vocab_offset(t: torch.Tensor) -> int:
    """First vocabulary id of this rank's rows of a vocab-parallel table."""
    return _model_mesh("vocab_offset").model_rank * t.shape[0]


# ---------------------------------------------------------------------------
# sharding rules (``ospo_tpu/parallel/mesh.py:54-160``)
# ---------------------------------------------------------------------------


def llama_param_specs() -> Dict[str, Any]:
    """Sharded axis of each leaf of the stacked Llama tree (layer axis
    first, projections ``[L, out, in]``): column-parallel matrices
    (qkv/gate/up) shard the out dim (1), row-parallel (o/down) the in dim
    (2)."""
    return {
        "embed": 0,                        # vocab-parallel embedding
        "layers": {
            "attn_norm": None,
            "wq": 1, "wk": 1, "wv": 1,     # column parallel (heads)
            "wo": 2,                       # row parallel
            "mlp_norm": None,
            "w_gate": 1, "w_up": 1,
            "w_down": 2,
        },
        "final_norm": None,
        "lm_head": 0,                      # vocab-parallel head
    }


def lora_param_specs(lora_tree: Dict) -> Dict[str, Any]:
    """A replicated, B sharded like its base projection's output dim; for
    the row-parallel o/down, A input-sharded and B replicated."""
    col = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"}
    return {name: ({"a": None, "b": 2} if name in col else {"a": 1, "b": None})
            for name in lora_tree}


def _map(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _replicated_like(tree: Any) -> Any:
    return _map(tree, lambda _: None)


def _module_specs(key: str, subtree: Any) -> Any:
    """Rules for one top-level Janus submodule."""
    if key == "language_model":
        return llama_param_specs()
    if key == "gen_head":
        return {"proj": {"w": None, "b": None},
                "head": {"w": 0, "b": 0}}          # [out, in]: vocab rows
    return _replicated_like(subtree)


def _quant_keys(params: Any) -> Optional[str]:
    """The payload key of a quantized weight dict, else None."""
    if isinstance(params, dict):
        for keys, payload in (({"q", "s"}, "q"), ({"q", "sa"}, "q"),
                              ({"q4", "s"}, "q4"), ({"q4", "gs"}, "q4")):
            if set(params) == keys:
                return payload
    return None


def _align_quant_specs(params: Any, specs: Any) -> Any:
    """Expand a matrix's spec over its quantized dict: the payload keeps
    it; the per-row scales ``s`` / ``sa`` keep it when it is an out-axis
    shard and are replicated when it shards the in axis; the group scales
    ``gs`` follow the out axis and are replicated otherwise, as in the JAX
    package (the JAX rule for an in-axis shard; this package cuts them
    with their payload's columns, :func:`shard_tree`)."""
    payload = _quant_keys(params)
    if payload is not None and not isinstance(specs, dict):
        scale = next(k for k in params if k != payload)
        ndim = params[scale].ndim
        if scale == "gs":
            ndim -= 1           # the spec of [..., F] over [..., F, G]
        axis = specs if specs is not None and specs < ndim else None
        return {payload: specs, scale: axis}
    if isinstance(params, dict) and isinstance(specs, dict):
        return {k: _align_quant_specs(params[k], specs.get(k)) for k in params}
    return specs


def janus_param_specs(params: Dict) -> Dict[str, Any]:
    specs = {k: _module_specs(k, v) for k, v in params.items()}
    specs = _align_quant_specs(params, specs)
    # drop_lm_head's (1, 1) stub cannot be divided; it stays replicated
    lm = params.get("language_model")
    if isinstance(lm, dict) and tuple(getattr(lm.get("lm_head"), "shape",
                                              ())) == (1, 1):
        specs["language_model"]["lm_head"] = None
    return specs


# ---------------------------------------------------------------------------
# cutting and joining the shards
# ---------------------------------------------------------------------------


def _cut(t: torch.Tensor, axis: int, k: int, mp: int, what: str) -> torch.Tensor:
    n = t.shape[axis]
    if n % mp:
        raise ValueError(f"{what}: axis {axis} of {tuple(t.shape)} does not "
                         f"divide into {mp} shards")
    return t.narrow(axis, k * (n // mp), n // mp).contiguous()


def _unpacked(q4: torch.Tensor) -> torch.Tensor:
    """Packed int4 rows [..., F/2, D] → int8 nibble values [..., F, D]
    (row r in the low nibble of packed row r, row r + F/2 in its high)."""
    low, high = unpack_int4_halves(q4)
    return torch.cat([low, high], dim=-2)


def _shard_quant(w: Dict, axis: int, k: int, mp: int, what: str) -> Dict:
    """This rank's shard of one quantized matrix, cut like its payload."""
    payload = _quant_keys(w)
    q = w[payload]
    out_axis = q.ndim - 2
    if axis == out_axis:
        if payload == "q4":
            # a packed byte holds rows r and r + F/2: cut the unpacked
            # rows, then pack this shard's own halves (exact: scales are
            # per row or per row-group, and follow their rows)
            rows = _cut(_unpacked(q), axis, k, mp, what)
            if rows.shape[axis] % 2:
                raise ValueError(f"{what}: int4 shards need an even number "
                                 f"of rows, got {rows.shape[axis]}")
            out = {"q4": _pack_halves(rows)}
        else:
            out = {payload: _cut(q, axis, k, mp, what)}
        for name, s in w.items():
            if name != payload:
                out[name] = _cut(s, axis, k, mp, what)
        return out
    # in-axis (row-parallel) shard: the payload's columns; per-row scales
    # stay whole, group scales take the groups of those columns
    out = {payload: _cut(q, axis, k, mp, what)}
    for name, s in w.items():
        if name == payload:
            continue
        if name == "gs":
            d, g = q.shape[-1], s.shape[-1]
            group = d // g
            if (d // mp) % group:
                raise ValueError(
                    f"{what}: int4g row-parallel shards need in dim / "
                    f"tensor_parallel ({d} / {mp}) to be a multiple of the "
                    f"scale group ({group}; ops/quant.INT4_GROUP = "
                    f"{INT4_GROUP})")
            s = _cut(s, s.ndim - 1, k, mp, what)
        out[name] = s
    return out


def _walk(params: Any, specs: Any, fn: Callable, path=()) -> Any:
    """``fn(path, leaf_or_quant_dict, axis)`` over the tree, a quantized
    dict taken whole with its payload's axis."""
    payload = _quant_keys(params)
    if payload is not None:
        return fn(path, params, specs[payload] if isinstance(specs, dict)
                  else specs)
    if isinstance(params, dict):
        return {k: _walk(v, specs[k] if isinstance(specs, dict) else specs,
                         fn, path + (k,)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_walk(v, specs[i] if isinstance(specs, (list, tuple))
                      else specs, fn, path + (i,))
                for i, v in enumerate(params)]
    return fn(path, params, specs)


def shard_tree(params: Dict, model_rank: int, model_parallel: int) -> Dict:
    """Model rank ``model_rank``'s shard of the full Janus tree: each
    sharded leaf's contiguous ``1/model_parallel`` of its axis; replicated
    leaves are the same tensors."""
    specs = janus_param_specs(params)

    def leaf(path, x, axis):
        what = ".".join(map(str, path))
        if axis is None:
            return x
        if isinstance(x, dict):
            return _shard_quant(x, axis, model_rank, model_parallel, what)
        return _cut(x, axis, model_rank, model_parallel, what)

    return _walk(params, specs, leaf)


def gather_tree(shards: Sequence[Dict]) -> Dict:
    """The full tree from every model rank's shard, in rank order: the
    inverse of :func:`shard_tree` (bit-equal)."""
    specs = janus_param_specs(shards[0])
    parts = [[] for _ in shards]

    def collect(i):
        def leaf(path, x, axis):
            parts[i].append(x)
            return x
        return leaf

    for i, s in enumerate(shards):
        _walk(s, specs, collect(i))
    it = iter(range(len(parts[0])))

    def join(path, x, axis):
        j = next(it)
        pieces = [p[j] for p in parts]
        if axis is None:
            return x
        if not isinstance(x, dict):
            return torch.cat(pieces, dim=axis)
        payload = _quant_keys(x)
        out_axis = x[payload].ndim - 2
        out = {}
        if axis == out_axis and payload == "q4":
            out["q4"] = _pack_halves(torch.cat(
                [_unpacked(p["q4"]) for p in pieces], dim=axis))
        else:
            out[payload] = torch.cat([p[payload] for p in pieces], dim=axis)
        for name in x:
            if name == payload:
                continue
            if axis == out_axis:
                out[name] = torch.cat([p[name] for p in pieces], dim=axis)
            elif name == "gs":
                out[name] = torch.cat([p[name] for p in pieces], dim=-1)
            else:
                out[name] = x[name]
        return out

    return _walk(shards[0], specs, join)


def shard_janus_params(params: Dict, mesh: Mesh) -> Dict:
    """This rank's shard of the Janus tree under ``mesh`` (the whole tree
    at one model rank).  The vocab-parallel tables are recorded so that
    the embedding and the heads know to join their ranks' slices."""
    if mesh.model == 1:
        return params
    local = shard_tree(params, mesh.model_rank, mesh.model)
    lm = local.get("language_model", {})
    head = local.get("gen_head", {}).get("head", {})
    for t in (lm.get("embed"), lm.get("lm_head"), head.get("w")):
        if isinstance(t, torch.Tensor) and tuple(t.shape) != (1, 1):
            _VOCAB_SHARDS[id(t)] = t
    return local


def shard_leaf(t, axis: Optional[int], mesh: Mesh, what: str = "leaf"):
    """This rank's contiguous ``1/model`` of ``t`` on ``axis`` (``t`` itself
    when ``axis`` is None or the group is one rank)."""
    if axis is None or mesh.model == 1:
        return t
    return _cut(torch.as_tensor(t), axis, mesh.model_rank, mesh.model, what)


# an integer type of each element size, to move a float tensor's bits
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_model(t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """The whole tensor of which each model rank holds the shard ``t``, cut
    on ``axis``, on the host: the shards' bits gathered over the group's
    gloo side and joined in rank order, so the result is bit-equal to the
    tensor that was cut (``gather_tree``'s join of one leaf).  A
    replicated ``t`` (``axis`` None) comes back as it is."""
    import torch.distributed as dist

    local = t.detach().contiguous().cpu()
    if axis is None:
        return local
    mesh = _model_mesh("gather_model")
    bits = local.view(_BITS[local.element_size()])
    parts = [torch.empty_like(bits) for _ in range(mesh.model)]
    dist.all_gather(parts, bits, group=mesh.object_group)
    return torch.cat(parts, dim=axis).view(local.dtype)

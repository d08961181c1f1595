"""Per-chip roofline terms of a dry-run cell — the port's counterpart of
the reference's ``launch.hlo_analysis``.

H100 SXM constants (NVIDIA's data sheet and Hopper white paper):
989 TFLOP/s bf16 dense on the tensor cores, 495 TF32, 67 float32 outside
them; 3.35 TB/s HBM; NVLink 450 GB/s each way a card. The whole mesh is
priced as one NVLink domain, the pod axis included: every collective's
link-bytes go at 450 GB/s, whichever axis it crosses.

The reference takes per-chip FLOPs and HBM bytes from its partitioned
program and the collective traffic from the collectives the partitioner
placed. The port has no partitioner, so:

* per-chip FLOPs and bytes are the step's global count (``op_count``)
  over ``n_chips``: the even-partition figure (``detail["partition"]``);
  replicated work would only add to a partitioned program's;
* collective link-bytes come from the rule table (``parallel.sharding``)
  and the step's shapes, at the reference's ring factors
  (``hlo_parse.HloCost.add_collective``: an all-reduce of S moves
  2·(g−1)/g·S a chip, an all-gather of output S (g−1)/g·S, a
  reduce-scatter of output S (g−1)·S, an all-to-all (g−1)/g·S, g the
  group). Per step:

  - each forward: an all-gather over ``data`` of every parameter whose
    spec holds ``data`` (FSDP), its output the TP-local shard;
  - in training also a second all-gather (the rematerialised backward)
    and a reduce-scatter over ``data`` of each such gradient, and, on a
    mesh with ``pod``, an all-reduce over ``pod`` of every gradient's
    local shard (parameters are replicated across pods);
  - an all-reduce over ``model`` of the activations after each
    row-parallel product whose contracted dimension resolves onto
    ``model`` (``wo``, ``w_down``, ``w_out``; the experts' ``w_down``
    when the experts fall back to TP over their hidden dim): the tokens
    of a data-parallel shard × d_model, once a forward, three times a
    training step (forward, rematerialised forward, backward);
  - the MoE's two all-to-alls over ``model`` (dispatch and combine) of
    the expert slots, (E · groups · capacity) × d_model, when the
    experts resolve onto ``model``, with the same passes;
  - the parameter collectives once a microbatch (8 above 5e10
    parameters, as the reference's dry run splits a training batch).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.models import ffn as ffn_mod
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as shd

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}  # per card, dense
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s each way per card

# row-parallel products: their leaf's first dimension is the contracted one
_ROW_PARALLEL = ("wo", "w_down", "w_out")
_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass
class Roofline:
    """All quantities are PER CHIP (even partition; see the module)."""

    flops: float
    hbm_bytes: float
    collective_link_bytes: float
    n_chips: int
    detail: dict = field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS["bfloat16"]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_link_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (perfect overlap of the three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops, "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_link_bytes_per_chip": self.collective_link_bytes,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "t_bound_s": self.t_bound,
            "detail": self.detail,
        }


class _Ring:
    """Collective bytes and per-chip link-bytes at the ring factors."""

    def __init__(self):
        self.bytes_by_kind: dict = {}
        self.counts: dict = {}
        self.link_bytes = 0.0

    def add(self, kind: str, nbytes: float, count: float, group: int):
        if group <= 1 or nbytes == 0:
            return
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.counts[kind] = self.counts.get(kind, 0.0) + count
        f = (group - 1) / group
        self.link_bytes += {"all-reduce": 2.0 * f * nbytes,
                            "all-gather": f * nbytes,
                            "reduce-scatter": (group - 1) * nbytes,
                            "all-to-all": f * nbytes}[kind]


def _expert_slots(cfg, tokens: int) -> int:
    """The MoE's (E · groups · capacity) slots for ``tokens`` tokens, as
    ``models.ffn.moe_forward`` lays them out."""
    g = min(cfg.moe_group_size, tokens)
    cap = ffn_mod._capacity(g, cfg.top_k_experts, cfg.n_experts,
                            cfg.capacity_factor)
    return cfg.n_experts * -(-tokens // g) * cap


def collectives(cfg, shape, mesh, params, pspecs, microbatches: int = 1):
    """(bytes by kind, counts by kind, per-chip link-bytes) of one step of
    the cell under the rule in the module's docstring. ``params`` are the
    cell's parameters (on ``meta``), ``pspecs`` their specs."""
    ring = _Ring()
    data = mesh.shape.get("data", 1)
    model = mesh.shape.get("model", 1)
    pod = mesh.shape.get("pod", 1)
    train = shape.kind == "train"
    passes = 3 if train else 1
    act = _DTYPE_BYTES[cfg.activation_dtype]
    b = shape.global_batch
    dp = ctx.axis_size(mesh, ctx.resolve(mesh, ctx.BATCH, b))
    b_local = b // dp
    dec_len = 1 if shape.kind == "decode" else (
        cfg.decoder_len if cfg.is_encoder_decoder else shape.seq_len)
    tokens = {"dec": b_local * dec_len,
              "enc": b_local * shape.seq_len}  # per data-parallel shard

    def leaf(path, p):
        spec = pspecs
        for k in path:
            spec = spec[k]
        local = math.prod(shd.local_shape(mesh, spec, p.shape)) \
            * p.element_size()
        if "data" in _axes(spec):  # FSDP-sharded
            gathers = microbatches * (2 if train else 1)
            ring.add("all-gather", gathers * local * data, gathers, data)
            if train:
                ring.add("reduce-scatter", microbatches * local,
                         microbatches, data)
        if train:
            ring.add("all-reduce", microbatches * local, microbatches, pod)
        name, group = shd.leaf_name(path), path[0]
        if group not in tokens or shape.kind == "decode" and group == "enc":
            return
        t = tokens[group]
        expert = name in ("w_up", "w_gate", "w_down") and p.ndim == 3
        if expert and name == "w_down":
            slots = _expert_slots(cfg, t) * cfg.d_model * act
            if "model" in _axes(spec[:1]):  # experts over model
                ring.add("all-to-all", 2 * passes * slots, 2 * passes, model)
            elif "model" in _axes(spec[1:2]):
                ring.add("all-reduce", passes * slots, passes, model)
        elif name in _ROW_PARALLEL and not expert and \
                "model" in _axes(spec[:1]):
            ring.add("all-reduce", t * cfg.d_model * act * passes, passes,
                     model)

    shd.map_with_path(leaf, params)
    return ring.bytes_by_kind, ring.counts, ring.link_bytes


def _axes(spec) -> set:
    out = set()
    for e in spec:
        if isinstance(e, str):
            out.add(e)
        elif e:
            out.update(e)
    return out


def roofline(count: dict, n_chips: int, coll: tuple, dtype: str) -> Roofline:
    """The cell's per-chip terms from its global ``op_count`` summary and
    its ``collectives``."""
    by_kind, counts, link = coll
    return Roofline(
        flops=count["flops"] / n_chips, hbm_bytes=count["bytes"] / n_chips,
        collective_link_bytes=link, n_chips=n_chips,
        peak_flops=PEAK_FLOPS[dtype],
        detail={
            "partition": "even: the global count over n_chips",
            "link_domain": "one NVLink domain, pod axis included, "
                           f"{NVLINK_BW:.3g} B/s each way",
            "peak_flops": PEAK_FLOPS[dtype], "hbm_bw": HBM_BW,
            "collective_bytes_by_kind": by_kind,
            "collective_counts": counts,
            "global_flops": count["flops"], "global_bytes": count["bytes"],
        })


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6·N_active·D (per step for train; per generated token × batch for
    decode; prefill counts forward-only ⇒ 2·N·D)."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * shape.global_batch  # decode: 1 tok/seq

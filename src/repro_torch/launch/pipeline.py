"""GPipe pipeline parallelism over a mesh axis: port of
``repro.launch.pipeline``.

Layer groups map to pipeline stages along a mesh axis (``pod`` by
default), as PICNIC maps layers to chiplet clusters: a stage holds
``n_groups / n_stages`` contiguous groups of every stacked layer leaf
(``stage_param_specs``), everything else (``embed``, ``lm_head``,
``final_norm``, zamba2's ``shared_attn``) replicated.  Stage 0 embeds, the
last stage computes the loss, and activations go from stage to stage
through ``sharding.ppermute``.  Only the dense, moe, ssm and hybrid
families: the reference embeds tokens only, with no encoder or prefix.

The schedule is written out, as GPipe is in PyTorch, where the reference
differentiates through its ``shard_map`` (the transpose of a ``ppermute``
is the reverse ``ppermute``): a collective inside autograd's backward
would need every rank to reach it in the same order.  ``n_micro +
n_stages - 1`` slots; in slot ``t`` stage ``s`` works microbatch ``t -
s`` where ``0 <= t - s < n_micro``, and every rank takes part in every
hand-off, with zeros where it idles.  The forward sweep keeps each slot's
input (a leaf that requires grad) and output; the last stage takes the
CE of its ``n_micro`` outputs at once (labels ``roll(tokens, -1, 1)``, no
mask).  The backward sweep runs the slots in reverse, each stage calling
``torch.autograd.backward`` on its slot's output and MoE aux loss and
handing its input's gradient to its predecessor.  The order of the
collectives is set by the slot index alone.  The reference also runs the
bubble slots and takes a loss on every stage, and masks them away; the
port skips both (the same numbers, fewer launches).

The stage runs with no sharding context (the reference's all-manual mode
has none), so a MoE block's aux loss is its own microbatch's.  The
gradients of the replicated leaves are SUM-all-reduced in float32 over the
stage group (the tied ``embed`` gets stage 0's embedding gradient and the
last stage's head gradient), then every leaf's over the ``dp_axes``
groups, each rank's loss having been seeded with ``1 / n_dp`` (the
reference's ``pmean``, ``sharding.batch_mean``'s rule).  Ranks along the
other axes hold the same tokens and get the same gradients.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import apply_norm
from repro_torch.models.model import group_layout, run_groups
from repro_torch.optim import clip_by_global_norm, linear_warmup_cosine, make_optimizer
from repro_torch.sharding import (Spec, axes_size, full_shape, gather_shard, local_shard,
                                  mesh_shape, ppermute, use_sharding)
from repro_torch.tree import tree_from_paths, tree_map, tree_paths
from .steps import cross_entropy

# the families whose forward is embed -> groups -> head, as the
# reference's pp_forward runs it
PP_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def stage_param_specs(params, stage_axis: str = "pod"):
    """The reference's ``_stage_param_specs``: every leaf under ``layers``
    cut on its leading (group) dim over ``stage_axis``, every other leaf
    replicated.  A tree of :class:`Spec` matching ``params`` (leaves with a
    ``.shape``)."""
    return tree_from_paths(
        (path, Spec(stage_axis) if "layers" in "/".join(path) and len(leaf.shape) >= 1
         else Spec())
        for path, leaf in tree_paths(params))


def pp_specs(cfg, params, mesh, stage_axis: str = "pod"):
    """The reference's ``pp_shardings`` as a tree of :class:`Spec`, for
    ``sharding.local_shard`` / ``gather_shard`` /
    ``launch.steps.shard_train_state``."""
    _stages(mesh, stage_axis)
    return stage_param_specs(params, stage_axis)


def pp_opt_state_specs(cfg, opt_state, stage_axis: str = "pod"):
    """The optimizer state's specs for ``make_pp_train_step``: AdamW's
    moments cut as their params (it runs on the stage's own leaves), its
    ``step`` replicated; Adafactor's state replicated whole (its factored
    statistics and its update clip span a stacked leaf, so it runs on the
    full leaves)."""
    if cfg.optimizer == "adafactor":
        return tree_map(lambda _: Spec(), opt_state)
    return stage_param_specs(opt_state, stage_axis)


def strip_axis(rules: Dict[str, Spec], axis: str) -> Dict[str, Spec]:
    """Remove a (now manual) mesh axis from activation rules: each entry
    keeps its other axes, None where none is left.  (The reference strips
    the stage axis from the rules its ``partial_manual`` schedule hands
    each stage; the port's all-manual schedule uses none.)"""
    out = {}
    for k, spec in rules.items():
        out[k] = Spec(*(None if e is None else (tuple(a for a in e if a != axis) or None)
                        for e in Spec(*spec)))
    return out


def _stages(mesh, stage_axis: str) -> int:
    shape = mesh_shape(mesh)
    if stage_axis not in shape:
        raise ValueError(f"the mesh {shape} has no stage axis {stage_axis!r}")
    return shape[stage_axis]


def _check(cfg, mesh, stage_axis: str) -> int:
    if cfg.family not in PP_FAMILIES:
        raise ValueError(f"{cfg.name}: the pipeline runs the {'/'.join(PP_FAMILIES)} "
                         f"families (it embeds tokens only), not {cfg.family!r}")
    n_stages = _stages(mesh, stage_axis)
    _, n_groups = group_layout(cfg)
    if n_groups % n_stages:
        raise ValueError(f"{cfg.name}: {n_groups} layer groups do not split into "
                         f"{n_stages} stages")
    return n_stages


def _micro(tokens, mesh, dp_axes, n_micro: int):
    """This rank's tokens as (n_micro, Bm, S): its rows over ``dp_axes``
    where they divide the batch, else the whole batch (the reference's
    ``bspec``)."""
    if tokens.shape[0] % axes_size(mesh, dp_axes) == 0:
        tokens = local_shard(tokens, Spec(tuple(dp_axes)), mesh)
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"a local batch of {B} does not split into {n_micro} microbatches")
    return tokens.reshape(n_micro, B // n_micro, S)


class _Schedule:
    """One rank's GPipe schedule on its stage's params ``params`` (leaves
    that require grad for a backward)."""

    def __init__(self, cfg, params, micro, mesh, stage_axis, dp_axes):
        self.cfg, self.params, self.micro, self.mesh = cfg, params, micro, mesh
        self.axis = stage_axis
        self.n = axes_size(mesh, (stage_axis,))
        self.s = mesh.get_local_rank(stage_axis)
        self.M, Bm, S = micro.shape
        self.last = self.s == self.n - 1
        self.dp_groups = tuple(mesh.get_group(a) for a in dp_axes
                               if axes_size(mesh, (a,)) > 1)
        self.n_dp = axes_size(mesh, dp_axes)
        self.idle = torch.zeros((Bm, S, cfg.d_model), dtype=params["embed"].dtype,
                                device=micro.device)
        self.stage = {"layers": params["layers"]}
        if "shared_attn" in params:
            self.stage["shared_attn"] = params["shared_attn"]
        self.slots = {}                 # microbatch -> (input, output, aux)

    def _hand_off(self, x, step: int):
        """Every stage's ``x`` to the stage ``step`` after it (+1 forward,
        -1 backward)."""
        perm = [(i, i + step) for i in range(self.n) if 0 <= i + step < self.n]
        with torch.no_grad():
            return ppermute(x, self.mesh, self.axis, perm)

    def forward(self):
        """The forward sweep: returns (this rank's CE, 0 but on the last
        stage, and its summed aux), float32."""
        positions = torch.arange(self.micro.shape[2], device=self.micro.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=self.micro.device)
        send = self.idle
        for t in range(self.M + self.n - 1):
            recv = self._hand_off(send, +1) if t else None
            m = t - self.s
            if not 0 <= m < self.M:
                send = self.idle
                continue
            if self.s == 0:
                x = F.embedding(self.micro[m], self.params["embed"])
            else:
                x = recv.requires_grad_(torch.is_grad_enabled())
            with use_sharding(None):
                y, aux = run_groups(self.cfg, self.stage, x, positions)
            self.slots[m] = (x, y, aux)
            aux_sum = aux_sum + aux.detach()
            send = y.detach()
        ce = torch.zeros((), dtype=torch.float32, device=self.micro.device)
        if self.last:
            self.outs = [self.slots[m][1].detach().requires_grad_(torch.is_grad_enabled())
                         for m in range(self.M)]
            h = apply_norm(self.cfg, self.params["final_norm"], torch.cat(self.outs))
            head = self.params["embed"].T if self.cfg.tie_embeddings \
                else self.params["lm_head"]
            labels = torch.roll(self.micro.reshape(-1, self.micro.shape[2]), -1, 1)
            self.ce = cross_entropy(h @ head, labels)
            ce = self.ce.detach()
        return ce, aux_sum

    def backward(self):
        """The backward sweep: accumulates the stage's gradients in its
        params' ``.grad`` (seeds ``1 / n_dp`` on the CE and ``0.01 /
        (n_micro n_dp)`` on each slot's aux)."""
        aux_seed = 0.01 / (self.M * self.n_dp)
        if self.last:
            torch.autograd.backward(self.ce * (1.0 / self.n_dp))
            dys = [o.grad for o in self.outs]
            del self.ce, self.outs
        send = self.idle
        for t in reversed(range(self.M + self.n - 1)):
            recv = self._hand_off(send, -1) if t < self.M + self.n - 2 else None
            m = t - self.s
            if not 0 <= m < self.M:
                send = self.idle
                continue
            x, y, aux = self.slots.pop(m)
            tensors, grads = [y], [dys[m] if self.last else recv]
            if aux.requires_grad:
                tensors.append(aux)
                grads.append(torch.full_like(aux, aux_seed))
            torch.autograd.backward(tensors, grads)
            send = x.grad if self.s > 0 else self.idle


def _reduce_metrics(sched, ce, aux_sum):
    """(loss, aux) of the global batch on every rank: the last stage's CE
    and the stages' aux summed over the stage group, / n_micro, then
    averaged over the data-parallel groups."""
    vals = torch.stack([ce, aux_sum])
    dist.all_reduce(vals, group=sched.mesh.get_group(sched.axis))
    vals = torch.stack([vals[0], vals[1] / sched.M])
    for g in sched.dp_groups:
        dist.all_reduce(vals, group=g)
    if sched.dp_groups:
        vals = vals / sched.n_dp
    return vals[0], vals[1]


def pp_forward(cfg, params, tokens, *, mesh, stage_axis: str = "pod", n_micro: int = 4,
               dp_axes: Sequence[str] = ("data",), partial_manual: bool = False):
    """The pipelined forward: (mean CE loss, MoE aux loss) of the global
    batch, 0-dim float32 tensors, the same on every rank, without grad (the
    train step's backward is ``pp_loss_and_grads``' explicit sweep).

    ``params``: this rank's shards by ``pp_specs`` (its stage's layer
    groups, the rest whole); ``tokens``: the global (B, S) batch, the same
    on every rank, of which a rank keeps its rows over ``dp_axes`` where
    they divide B (else all of them).  The stage runs with no sharding
    context, as in the reference's all-manual schedule;
    ``partial_manual=True`` (the reference's schedule manual over the stage
    axis only, GSPMD cutting each stage over the other axes with its
    activation rules) is not ported.  A collective over the mesh."""
    if partial_manual:
        raise NotImplementedError("pp_forward(partial_manual=True): the stage axis alone "
                                  "manual is not ported (ROADMAP §A6d); the all-manual "
                                  "schedule is")
    _check(cfg, mesh, stage_axis)
    with torch.no_grad():
        sched = _Schedule(cfg, params, _micro(tokens, mesh, dp_axes, n_micro), mesh,
                          stage_axis, dp_axes)
        return _reduce_metrics(sched, *sched.forward())


def pp_loss_and_grads(cfg, params, tokens, *, mesh, stage_axis: str = "pod",
                      n_micro: int = 4, dp_axes: Sequence[str] = ("data",)):
    """(loss, aux, grads) of the pipelined loss ``loss + 0.01 aux`` at this
    rank's shards ``params`` (see ``pp_forward``): the forward and the
    backward sweep, then the replicated leaves' gradients SUM-all-reduced
    in float32 over the stage group and every leaf's over the
    data-parallel groups.  ``grads`` has ``params``' nesting and shards;
    a leaf the rank's loss does not reach gets zeros before the sums."""
    _check(cfg, mesh, stage_axis)
    micro = _micro(tokens, mesh, dp_axes, n_micro)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        sched = _Schedule(cfg, leaves, micro, mesh, stage_axis, dp_axes)
        ce, aux_sum = sched.forward()
        sched.backward()
    loss, aux = _reduce_metrics(sched, ce, aux_sum)
    specs = dict(tree_paths(stage_param_specs(params, stage_axis)))
    stage_group = mesh.get_group(stage_axis)

    def reduced(path, p):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        groups = sched.dp_groups if any(specs[path]) else (stage_group, *sched.dp_groups)
        if not groups:
            return g
        g32 = g.to(torch.float32, copy=True)
        for group in groups:
            dist.all_reduce(g32, group=group)
        return g32.to(g.dtype)

    with torch.no_grad():
        grads = tree_from_paths((path, reduced(path, p)) for path, p in tree_paths(leaves))
    return loss, aux, grads


def _global_norm(grads, specs, mesh, stage_axis):
    """The global norm of the whole tree from this stage's slice of it:
    each leaf's float32 sum of squares, the stage-cut leaves' summed over
    the stage group, added in the tree's order (the replicated leaves
    once)."""
    paths = [path for path, _ in tree_paths(grads)]
    sq = [torch.sum(torch.square(g.to(torch.float32))) for _, g in tree_paths(grads)]
    cut = [i for i, path in enumerate(paths) if any(specs[path])]
    if cut:
        v = torch.stack([sq[i] for i in cut])
        dist.all_reduce(v, group=mesh.get_group(stage_axis))
        for j, i in enumerate(cut):
            sq[i] = v[j]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def make_pp_train_step(cfg, mesh, *, stage_axis: str = "pod", n_micro: int = 4,
                       dp_axes: Sequence[str] = ("data",), base_lr=3e-4, warmup=100,
                       total_steps=10000):
    """``step(params, opt_state, tokens)`` -> (params, opt_state, metrics):
    the pipeline-parallel train step on this rank's shards (params by
    ``pp_specs``, the state by ``pp_opt_state_specs``; ``tokens`` the
    global batch, as ``pp_forward``).  The loss ``loss + 0.01 aux`` and its
    gradients (``pp_loss_and_grads``), the global-norm clip at 1.0 over the
    whole tree (the stage-cut leaves' squares summed over the stage
    group), the warmup-cosine LR of the state's step, then the config's
    optimizer: AdamW elementwise on the stage's own leaves, Adafactor on
    the full leaves (gathered over the stages) with its replicated state,
    each rank keeping its shards.  The replicated leaves stay equal on
    every stage, bit for bit.  Metrics are the reference's: ``loss`` (the
    CE, without the aux term), ``aux`` and ``grad_norm``, 0-dim float32,
    the same on every rank."""
    _check(cfg, mesh, stage_axis)
    _, opt_update = make_optimizer(cfg.optimizer)

    def gather(t, spec):
        return gather_shard(t, spec, mesh, full_shape(t.shape, spec, mesh))

    def step(params, opt_state, tokens):
        loss, aux, grads = pp_loss_and_grads(cfg, params, tokens, mesh=mesh,
                                             stage_axis=stage_axis, n_micro=n_micro,
                                             dp_axes=dp_axes)
        pspecs = stage_param_specs(params, stage_axis)
        specs = dict(tree_paths(pspecs))
        with torch.no_grad():
            gnorm = _global_norm(grads, specs, mesh, stage_axis)
            grads, gnorm = clip_by_global_norm(grads, 1.0, norm=gnorm)
            lr = linear_warmup_cosine(opt_state["step"].to(torch.float32), base_lr=base_lr,
                                      warmup_steps=warmup, total_steps=total_steps)
            params = tree_map(lambda p: p.detach(), params)
            if cfg.optimizer == "adafactor":
                full = lambda tree: tree_from_paths((path, gather(t, specs[path]))
                                                    for path, t in tree_paths(tree))
                new_full, opt_state = opt_update(full(params), full(grads), opt_state, lr=lr)
                params = tree_from_paths((path, local_shard(t, specs[path], mesh))
                                         for path, t in tree_paths(new_full))
            else:
                params, opt_state = opt_update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "aux": aux, "grad_norm": gnorm}

    return step

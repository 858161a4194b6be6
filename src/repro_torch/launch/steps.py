"""Step functions: train_step, prefill_step and serve_step (decode), with
greedy sampling.  Port of ``repro.launch.steps``: ``cross_entropy``,
``make_loss_fn``, ``make_train_step``, ``init_train_state``,
``make_prefill_step`` and ``make_serve_step``; ``CompiledServeStep``, the
serve step captured once as a CUDA graph (the counterpart of the
reference's ``jax.jit(serve_step, donate_argnums=(1,))`` in
``launch/serve.py``); ``CompiledTrainStep``, the train step captured
once as a CUDA graph with its params and optimizer state donated (the
counterpart of ``jax.jit(train_step, donate_argnums=(0, 1))`` in
``launch/train.py``), whose body is ``make_train_body``; and
``make_sharded_train_step``, the data-parallel train step on a rank's
shards (the counterpart of the reference's ``jax.jit(..., in_shardings=)``
over a mesh), with ``shard_train_state`` / ``gather_train_state``."""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.models.attention import picnic_active, sp_axes
from repro_torch.sharding import (axes_groups, axes_index, axes_size, current, dp_axes,
                                  full_shape, gather_shard, local_cache, local_shard,
                                  use_sharding)
from repro_torch.kernels._build import LAUNCHES, LAUNCHES_BY_SHAPE
from repro_torch.optim import clip_by_global_norm, linear_warmup_cosine, make_optimizer
from repro_torch.tree import tree_from_paths, tree_map, tree_paths

# the RRAM weight noise's seed of a step: (NOISE_SEED, step), as the
# reference folds the step into PRNGKey(17)
NOISE_SEED = 17


def cross_entropy(logits, labels, mask=None, *, count=None):
    """Mean next-token CE: float32 logsumexp, masked mean over ``mask``.
    ``count`` (a 0-dim tensor): the divisor instead of this batch's mask
    sum (or token count), as a data-parallel rank divides its shard's sum
    by the global batch's, so that the ranks' losses add up to the global
    mean."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if count is not None:
        return torch.sum(nll if mask is None else nll * mask) / count
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def _noisy(leaf) -> bool:
    """The leaves the RRAM noise multiplies: floating, >= 2 dims."""
    return leaf.is_floating_point() and leaf.ndim >= 2


def noise_seed(step: int) -> int:
    """The seed of the RRAM noise's generator at ``step``: (NOISE_SEED,
    step) folded into one integer."""
    return NOISE_SEED * 1_000_003 + int(step)


def weight_noise(params, std: float, step=None, *, generator=None):
    """The RRAM noise factors ``1 + std * N(0, 1)`` (float32) of every
    leaf that takes noise (None elsewhere), drawn one leaf after the other
    in the JAX package's order from ``generator`` (on the params' device),
    or else from a new one seeded by ``noise_seed(step)``: a caller that
    seeds its own generator with ``noise_seed(step)`` draws the same
    factors.  The draws are the port's own, not JAX's (the distributions
    are the same)."""
    items = list(tree_paths(params))
    dev = items[0][1].device
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(noise_seed(step))
    return tree_from_paths(
        (path, 1 + std * torch.randn(leaf.shape, generator=gen, device=dev,
                                     dtype=torch.float32) if _noisy(leaf) else None)
        for path, leaf in items)


def _global_count(batch, groups):
    """The global batch's mask sum (its token count without a mask),
    all-reduced over ``groups``, at least 1: a data-parallel loss's
    divisor."""
    with torch.no_grad():
        mask = batch.get("mask")
        n = (mask.sum() if mask is not None else
             torch.tensor(batch["labels"].numel(), device=batch["labels"].device)).to(torch.float32)
        for g in groups:
            dist.all_reduce(n, group=g)
        return torch.clamp(n, min=1)


def make_loss_fn(cfg, *, weight_noise_std: float = 0.0, dp_groups=()):
    """weight_noise_std > 0 enables the paper's noise-resilient training
    (§IV / [13]): multiplicative Gaussian noise on the weights during the
    forward pass models RRAM conductance relaxation.

    ``loss_fn(params, batch, noise=None)`` -> (loss, {"ce", "aux"}).  With
    noise on, ``noise`` is a tree of factors with the params' nesting
    (``weight_noise`` gives the port's own; a test may pass the JAX
    package's); without it the loss is the clean one.  A leaf becomes
    ``leaf * factor.to(leaf.dtype)``, as the reference casts ``1 + std *
    normal`` to the leaf's dtype.

    ``dp_groups``: the process groups over which the batch is cut (a
    data-parallel rank's, and under the sequence cut a sequence-parallel
    rank's); its ``ce`` is then this shard's share of the global batch's,
    ``cross_entropy(..., count=)`` of the global mask sum, and the ranks'
    ``ce`` add up to the global one.  Under the sequence cut
    (``models.local_text_rows``) the labels and mask are cut to the text
    rows whose logits this rank's forward returns."""
    def loss_fn(params, batch, noise=None):
        p = params
        if weight_noise_std > 0.0 and noise is not None:
            p = tree_map(lambda l, f: l if f is None or not _noisy(l) else l * f.to(l.dtype),
                         params, noise)
        prefix = batch.get("prefix_embeds")
        logits, aux, _ = models.forward(cfg, p, batch["tokens"], prefix_embeds=prefix,
                                        encoder_embeds=batch.get("encoder_embeds"))
        rows = models.local_text_rows(batch["tokens"].shape[1],
                                      0 if prefix is None else prefix.shape[1])
        mask = batch.get("mask")
        cut = {"labels": batch["labels"][:, rows],
               **({} if mask is None else {"mask": mask[:, rows]})}
        count = _global_count(cut, dp_groups) if dp_groups else None
        ce = cross_entropy(logits, cut["labels"], cut.get("mask"), count=count)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def _loss_and_grads(loss_fn, params, batch, noise):
    """(loss, its parts, the gradient tree) of ``loss_fn`` at ``params``
    (leaves that require grad); a leaf the loss does not reach gets
    zeros."""
    paths, leaves = zip(*tree_paths(params))
    with torch.enable_grad():
        loss, parts = loss_fn(params, batch, noise=noise)
        grad_leaves = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_from_paths((path, torch.zeros_like(leaf) if g is None else g)
                            for path, leaf, g in zip(paths, leaves, grad_leaves))
    return loss, parts, grads


def _make_step(cfg, *, base_lr, warmup, total_steps, max_grad_norm, weight_noise_std):
    """``step(params, opt_state, batch, noise, donate)`` -> (params,
    opt_state, metrics): one train step on params that are leaves which
    require grad, with the RRAM noise factors ``noise`` (or None)."""
    loss_fn = make_loss_fn(cfg, weight_noise_std=weight_noise_std)
    _, opt_update = make_optimizer(cfg.optimizer)

    def step(params, opt_state, batch, noise, donate):
        loss, parts, grads = _loss_and_grads(loss_fn, params, batch, noise)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = linear_warmup_cosine(opt_state["step"].to(torch.float32),
                                      base_lr=base_lr, warmup_steps=warmup,
                                      total_steps=total_steps)
            params, opt_state = opt_update(params, grads, opt_state, lr=lr, donate=donate)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return step


def make_train_step(cfg, *, base_lr=3e-4, warmup=100, total_steps=10000,
                    max_grad_norm=1.0, weight_noise_std: float = 0.0):
    """``train_step(params, opt_state, batch, noise=None)`` -> (params,
    opt_state, metrics): the loss and its gradient by autograd (through
    ``kernels.flash_attention.FlashAttentionFn`` and
    ``kernels.ssd_scan.SSDScanFn`` on the card), global-norm clipping, the
    warmup-cosine LR of the state's step and the config's optimizer.
    Params are leaves that require grad; the new ones are too.  The
    optimizer may update its state in place (AdamW's moments).  The update
    runs under ``torch.no_grad()``; metrics (``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``) are 0-dim tensors, read by nobody here.
    ``noise``: the RRAM noise factors for this step (see
    ``make_loss_fn``); by default drawn for the state's step, which is
    then read on the host."""
    step = _make_step(cfg, base_lr=base_lr, warmup=warmup, total_steps=total_steps,
                      max_grad_norm=max_grad_norm, weight_noise_std=weight_noise_std)

    def train_step(params, opt_state, batch, noise=None):
        params = tree_map(lambda p: p if p.requires_grad else p.detach().requires_grad_(True),
                          params)
        if weight_noise_std > 0.0 and noise is None:
            noise = weight_noise(params, weight_noise_std, int(opt_state["step"]))
        params, opt_state, metrics = step(params, opt_state, batch, noise, False)
        return tree_map(lambda p: p.requires_grad_(True), params), opt_state, metrics

    return train_step


def make_train_body(cfg, *, base_lr=3e-4, warmup=100, total_steps=10000,
                    max_grad_norm=1.0, weight_noise_std: float = 0.0):
    """``body(params, opt_state, batch, generator=None)`` -> metrics: the
    train step that ``CompiledTrainStep`` captures, runnable eagerly on any
    device.  The same numbers as ``make_train_step``'s step, bit for bit,
    but the params (leaves that require grad) and the state are updated IN
    PLACE, the state's ``step`` included, and nothing is read on the host:
    the RRAM noise factors, with noise on, are drawn from ``generator``,
    which the caller has seeded with ``noise_seed(step)`` for the state's
    step."""
    step = _make_step(cfg, base_lr=base_lr, warmup=warmup, total_steps=total_steps,
                      max_grad_norm=max_grad_norm, weight_noise_std=weight_noise_std)

    def body(params, opt_state, batch, generator=None):
        noise = None
        if weight_noise_std > 0.0:
            if generator is None:
                raise ValueError("the weight noise is on: pass the generator seeded with "
                                 "noise_seed(step)")
            noise = weight_noise(params, weight_noise_std, generator=generator)
        return step(params, opt_state, batch, noise, True)[2]

    return body


def _zip_specs(tree, specs):
    """(path, leaf, spec) over the leaves of ``tree`` and its spec tree."""
    spec_of = dict(tree_paths(specs))
    return [(path, leaf, spec_of[path]) for path, leaf in tree_paths(tree)]


def shard_train_state(params, opt_state, pspecs, ospecs, mesh):
    """This rank's shards of global params and optimizer state (on every
    rank the same), cut by ``pspecs`` / ``ospecs`` (``sharding.specs``):
    contiguous copies, the params' without grad."""
    return tuple(tree_from_paths((path, local_shard(leaf, spec, mesh))
                                 for path, leaf, spec in _zip_specs(tree, specs))
                 for tree, specs in ((params, pspecs), (opt_state, ospecs)))


def gather_train_state(params, opt_state, pspecs, ospecs, mesh):
    """``shard_train_state``'s inverse: the global params and optimizer
    state from every rank's shards (what a checkpoint holds).  A
    collective over the mesh."""
    return tuple(tree_from_paths(
        (path, gather_shard(leaf, spec, mesh, full_shape(leaf.shape, spec, mesh)))
        for path, leaf, spec in _zip_specs(tree, specs))
        for tree, specs in ((params, pspecs), (opt_state, ospecs)))


def make_sharded_train_step(cfg, ctx, pspecs, ospecs, *, base_lr=3e-4, warmup=100,
                            total_steps=10000, max_grad_norm=1.0,
                            weight_noise_std: float = 0.0):
    """``step(params, opt_state, batch)`` -> (params, opt_state, metrics)
    on this rank's shards: the counterpart of the reference's
    ``jax.jit(train_step, in_shardings=to_named((pspecs, ospecs,
    bspecs)))`` under the sharding context ``ctx`` (``ctx.mesh`` a
    ``DeviceMesh``; one process a rank).

    ``params`` / ``opt_state`` are this rank's shards by ``pspecs`` /
    ``ospecs`` (``shard_train_state``), ``batch`` its shard by
    ``batch_specs``, which must cut the batch over all of ``ctx``'s
    data-parallel axes (``ShardingCtx.dp_groups``).  Under ``ctx``'s
    ``sp_attention`` with seq axes that divide the batch's positions
    (``models.attention.sp_axes``), the forward keeps this rank's rows of
    the sequence and the loss its text rows: ranks along the seq axes
    hold other tokens of the same batch shard, and every reduction below
    that runs over the data-parallel groups runs over the seq groups
    (``ShardingCtx.sp_groups``) too; seq axes that share an axis with the
    data-parallel ones are refused.  A step gathers every
    param (``gather_shard``) as a leaf that requires grad, and takes the
    loss of its batch shard under ``ctx``: its mask sum over the global
    batch's (``make_loss_fn(dp_groups=)``), the MoE aux loss from global
    batch means (``models.moe``), the RRAM noise factors drawn on the full
    leaves from ``noise_seed(step)`` (the same on every rank).  The
    gradients are SUM-all-reduced (in float32) over the data-parallel
    groups (and the seq groups under the sequence cut): ranks along the
    other axes hold the same tokens and the same gradients.  Then the
    global-norm clip on the full gradients, the LR of the replicated
    ``step`` and the optimizer: AdamW, elementwise,
    on the slice of each leaf that ``ospecs`` gives this rank's moments, the
    new slices gathered over the optimizer's axes where the param is cut
    otherwise; Adafactor, whose row / column statistics and update clip
    span a leaf, on the full leaf, its ``vr`` / ``vc`` gathered.  The
    result is the single-device update, up to the order of the data-parallel
    sum.  Metrics (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``) are the
    global batch's, the same on every rank.  Collectives: all-reduce and
    all-gather only, every rank of the mesh calling the step in step."""
    mesh = ctx.mesh
    dp = ctx.opt("dp_axes") or dp_axes(mesh)
    seq = tuple(ctx.opt("seq_axes", ("model",)))
    if ctx.sp_groups() and set(dp) & set(seq):
        raise ValueError(f"make_sharded_train_step: the sequence cut over {seq} shares an axis "
                         f"with the batch cut over {tuple(dp)}")
    _, opt_update = make_optimizer(cfg.optimizer)
    elementwise = cfg.optimizer == "adamw"

    def gather(leaf, spec):
        return gather_shard(leaf, spec, mesh, full_shape(leaf.shape, spec, mesh))

    def allreduce_sum(t, groups):
        t32 = t.to(torch.float32, copy=True)
        for g in groups:
            dist.all_reduce(t32, group=g)
        return t32.to(t.dtype)

    def step(params, opt_state, batch):
        full = tree_from_paths((path, gather(leaf, spec).requires_grad_(True))
                               for path, leaf, spec in _zip_specs(params, pspecs))
        noise = (weight_noise(full, weight_noise_std, int(opt_state["step"]))
                 if weight_noise_std > 0.0 else None)
        prefix = batch.get("prefix_embeds")
        rows = batch["tokens"].shape[1] + (0 if prefix is None else prefix.shape[1])
        groups = ctx.dp_groups() + (ctx.sp_groups() if sp_axes(rows, ctx) else ())
        loss_fn = make_loss_fn(cfg, weight_noise_std=weight_noise_std, dp_groups=groups)
        with use_sharding(ctx):
            _, parts, grads = _loss_and_grads(loss_fn, full, batch, noise)
        with torch.no_grad():
            grads = tree_map(lambda t: allreduce_sum(t, groups), grads)
            ce = allreduce_sum(parts["ce"].detach(), groups)
            aux = parts["aux"].detach()
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = linear_warmup_cosine(opt_state["step"].to(torch.float32), base_lr=base_lr,
                                      warmup_steps=warmup, total_steps=total_steps)
            full = tree_map(lambda t: t.detach(), full)
            if elementwise:
                params, opt_state = _sliced_update(full, grads, params, opt_state, lr)
            else:
                params, opt_state = _full_update(full, grads, opt_state, lr)
        metrics = {"loss": ce + 0.01 * aux, "ce": ce, "aux": aux, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    def _sliced_update(full, grads, params, opt_state, lr):
        mspecs = dict(tree_paths(ospecs["m"]))
        pspec_of = dict(tree_paths(pspecs))
        slices = lambda tree: tree_from_paths((path, local_shard(t, mspecs[path], mesh))
                                              for path, t in tree_paths(tree))
        new_slices, opt_state = opt_update(slices(full), slices(grads), opt_state, lr=lr)
        out = []
        for path, t in tree_paths(new_slices):
            if mspecs[path] != pspec_of[path]:
                t = local_shard(gather(t, mspecs[path]), pspec_of[path], mesh)
            out.append((path, t))
        return tree_from_paths(out), opt_state

    def _full_update(full, grads, opt_state, lr):
        state = tree_from_paths((path, gather(t, spec))
                                for path, t, spec in _zip_specs(opt_state, ospecs))
        new_full, new_state = opt_update(full, grads, state, lr=lr)
        return shard_train_state(new_full, new_state, pspecs, ospecs, mesh)

    return step


def init_train_state(cfg, gen: torch.Generator):
    """Random params from ``gen`` on its device (leaves that require grad)
    and the config's optimizer state."""
    params = tree_map(lambda p: p.requires_grad_(True), models.init_params(cfg, gen))
    opt_init, _ = make_optimizer(cfg.optimizer)
    return params, opt_init(params)


def make_prefill_step(cfg, *, kv_max: int):
    """``batch``: ``tokens`` (B, S), ``prefix_embeds`` (B, P, d) for a
    prefix-LM (paligemma's patch embeddings; the cache then holds P + S
    rows) and ``encoder_embeds`` (B, S_enc, d) for an encoder-decoder
    (whisper).

    Under a context with ``sp_attention`` whose seq axes divide the P + S
    positions (``models.attention.sp_axes``) each rank runs its rows of
    the sequence (``batch`` is its batch shard): the next token is the
    argmax of the global last row, which the last seq rank holds, summed
    over the seq groups so that every rank returns it, and the cache holds
    the gathered K/V of the whole sequence.  With ``picnic_decode`` on as
    well (``models.attention.picnic_active``) the step returns this rank's
    cache shard (``sharding.local_cache``'s rows over the seq axes; the
    batch is already cut), from which the PICNIC decode step goes on."""
    @torch.no_grad()
    def prefill_step(params, batch):
        prefix = batch.get("prefix_embeds")
        logits, _, cache = models.forward(cfg, params, batch["tokens"], prefix_embeds=prefix,
                                          encoder_embeds=batch.get("encoder_embeds"),
                                          collect_cache=True, kv_max=kv_max)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        ctx = current()
        seq = sp_axes(batch["tokens"].shape[1] + (0 if prefix is None else prefix.shape[1]), ctx)
        if seq:
            if axes_index(ctx.mesh, seq) != axes_size(ctx.mesh, seq) - 1:
                next_tok = torch.zeros_like(batch["tokens"][:, :1], dtype=torch.long)
            for g in axes_groups(ctx.mesh, seq):
                dist.all_reduce(next_tok, group=g)
        if picnic_active(ctx):
            cache = local_cache(cache, ctx.mesh, seq_axes=tuple(ctx.opt("seq_axes", ("model",))),
                                dp_axes=())
        return next_tok, cache
    return prefill_step


def make_serve_step(cfg):
    """One decode step: append token, attend over the cache, greedy-sample
    the next token.  The cache is updated in place."""
    @torch.no_grad()
    def serve_step(params, cache, token, cache_len):
        logits, cache = models.decode_step(cfg, params, token, cache,
                                           cache_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        return next_tok, cache
    return serve_step


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def tensor_addresses(*trees) -> Dict[str, Tuple]:
    """Each tensor of the trees by its path: (address, shape, dtype), what
    a captured graph reads and writes."""
    return {f"{i}{path}": (t.data_ptr(), tuple(t.shape), t.dtype)
            for i, tree in enumerate(trees) for path, t in _leaves(tree)}


def _attention_rows(cache):
    """Rows of the contiguous self-attention cache (never the cross
    cache's), or None for a model without attention (its decode reads no
    length)."""
    for entry in cache.values():
        if "k" in entry:
            return entry["k"].shape[2]
    return None


def _launch_counts():
    return dict(LAUNCHES), dict(LAUNCHES_BY_SHAPE)


def _take_back(counts):
    """Restore the launch counters to ``counts`` and return what was
    counted since: (per kernel, per (kernel, shape))."""
    before, shapes = counts
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    by_shape = {k: n - shapes.get(k, 0) for k, n in LAUNCHES_BY_SHAPE.items()
                if n != shapes.get(k, 0)}
    LAUNCHES.update(before)
    LAUNCHES_BY_SHAPE.clear()
    LAUNCHES_BY_SHAPE.update(shapes)
    return launches, by_shape


def _add_launches(launches, by_shape):
    for name, n in launches.items():
        LAUNCHES[name] += n
    for key, n in by_shape.items():
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + n


class CompiledServeStep:
    """The serve step captured once as a CUDA graph over one params tree
    and one cache, the counterpart of the reference's jitted step with its
    cache donated: ``cache_len`` is a 0-dim device tensor inside the graph
    (one graph serves every length), the cache is updated in place at its
    own addresses, and the token, length and next token live in static
    buffers.

    Building it runs one eager step first (kernel builds, kernel
    attributes, cuBLAS heuristics, the allocator), on a copy of the cache
    so the cache is left as it was, then captures the step.  A call copies
    the token and length into the static buffers, replays the graph and
    returns ``(next_token, cache)``; ``next_token`` is the static output,
    overwritten by the next call, so copy it to keep it.  A call whose
    params or cache are not the captured tensors raises: the graph would
    read or write the captured addresses.  A failed capture or replay
    raises; nothing falls back to the eager step.

    ``kernels.ops.LAUNCHES`` (and ``LAUNCHES_BY_SHAPE``) count a kernel
    launch when its wrapper runs, which for a graph is during capture; the
    capture's counts are taken back and added again on every replay, so
    the counters read as the eager step's would.  ``logits`` is the static (B, 1, V) output of the
    last call.

    Under a PICNIC context (``models.attention.picnic_active``) the step
    all-reduces over the seq axes' process groups; gloo runs those on the
    host, which a graph cannot capture, so a context whose groups are not
    all NCCL raises ``ValueError``.  (A captured NCCL picnic step needs
    several cards and is untried.)"""

    def __init__(self, cfg, params, cache, batch: int):
        ctx = current()
        n_seq = 1
        if picnic_active(ctx):
            seq_axes = ctx.opt("seq_axes", ("model",))
            backends = {dist.get_backend(g) for g in axes_groups(ctx.mesh, seq_axes)}
            if backends != {"nccl"}:
                raise ValueError(f"CompiledServeStep: the PICNIC decode's all-reduces over "
                                 f"{sorted(backends)} groups cannot be captured in a CUDA "
                                 f"graph; only NCCL's can")
            n_seq = axes_size(ctx.mesh, seq_axes)
        self.device = next(_leaves(cache))[1].device
        if self.device.type != "cuda":
            raise ValueError("CompiledServeStep captures a CUDA graph: it "
                             "takes a cache on a CUDA device")
        rows = _attention_rows(cache)           # a shard's under PICNIC
        self.max_len = None if rows is None else rows * n_seq
        self.token = torch.zeros((batch, 1), dtype=torch.long,
                                 device=self.device)
        self.cache_len = torch.ones((), dtype=torch.long, device=self.device)
        self.addresses = tensor_addresses(params, cache)

        def step(c):
            logits, _ = models.decode_step(cfg, params, self.token, c,
                                           self.cache_len)
            return logits, torch.argmax(logits[:, -1:], dim=-1)

        with torch.no_grad():
            step({k: {n: t.clone() for n, t in e.items()}
                  for k, e in cache.items()})                   # warm-up
            torch.cuda.synchronize(self.device)
            counts = _launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    self.logits, self.next_token = step(cache)
            finally:
                self.launches, self.launches_by_shape = _take_back(counts)

    def __call__(self, params, cache, token, cache_len: int):
        if tensor_addresses(params, cache) != self.addresses:
            raise ValueError("CompiledServeStep: params or cache are not the "
                             "tensors the graph was captured on; build a new "
                             "step for them")
        if self.max_len is not None and not 1 <= cache_len <= self.max_len:
            raise ValueError(f"cache_len {cache_len} outside [1, {self.max_len}]")
        self.token.copy_(token)
        self.cache_len.fill_(cache_len)
        self.graph.replay()
        _add_launches(self.launches, self.launches_by_shape)
        return self.next_token, cache


class CompiledTrainStep:
    """The train step (loss, autograd backward, global-norm clip,
    warmup-cosine LR, the config's optimizer) captured once as a CUDA
    graph over one params tree and one optimizer state, which it updates
    in place: the counterpart of the reference's ``jax.jit(train_step,
    donate_argnums=(0, 1))``.  The graph runs ``make_train_body``'s body,
    the same numbers as ``make_train_step``.

    ``step(params, opt_state, batch)`` -> ``(params, opt_state, metrics)``
    takes the tensors the step was built on and returns them updated.  The
    state's ``step`` is a 0-dim device tensor that the graph increments and
    the LR is computed from on the device.  The batch (``tokens``,
    ``labels``, ``mask``, and ``prefix_embeds`` or ``encoder_embeds``) is
    copied into static buffers, made by the first call at its shapes.
    ``metrics`` (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``) are
    static 0-dim tensors, overwritten by the next call: read or copy them
    before it.

    The first call is a real step of the run, run eagerly on a side stream:
    it builds the kernels, sets their attributes at first launch, picks the
    cuBLAS heuristics and runs autograd's set-up.  The second captures the
    step (a capture executes nothing), then replays it, as does every call
    after.  Both first empty the caching allocator, which keeps its cached
    blocks per stream.  The graph's private pool keeps one step's
    activations and gradients for its life (``pool_bytes``).

    With the RRAM weight noise on, the class keeps the step on the host
    (read from the state once when built and once in ``load``, advanced by
    each call) and seeds a generator registered with the graph with
    ``noise_seed(step)`` before each call, so a replay draws for step s the
    factors ``weight_noise(params, std, s)`` draws.

    ``load(params, opt_state)`` copies other tensors (a restored
    checkpoint, a fresh state) into the captured ones.  A call whose
    params or state are not the captured tensors, or whose batch has other
    keys, shapes or dtypes, raises ``ValueError``; a failed capture or
    replay raises.  Nothing falls back to the eager step, and a CPU device
    is refused: the eager ``make_train_step`` is the caller's choice there.

    ``kernels.ops.LAUNCHES`` and ``LAUNCHES_BY_SHAPE`` count as for
    ``CompiledServeStep``: the capture's counts are taken back and added
    again on every replay, so the counters read as the eager step's.

    The step is the single-device one: under a sharding context whose
    data-parallel axes, or under ``sp_attention`` whose seq axes, hold more
    than one rank it raises.  Over gloo groups
    (``ValueError``) a data-parallel step's all-reduces run on the host,
    which a graph cannot capture; over NCCL (``NotImplementedError``) a
    captured sharded step waits for several cards, and
    ``make_sharded_train_step`` runs eagerly."""

    def __init__(self, cfg, params, opt_state, *, base_lr=3e-4, warmup=100,
                 total_steps=10000, max_grad_norm=1.0, weight_noise_std: float = 0.0):
        ctx = current()
        groups = ctx.dp_groups() + ctx.sp_groups() if ctx is not None else ()
        if groups:
            backends = {dist.get_backend(g) for g in groups}
            if backends != {"nccl"}:
                raise ValueError(f"CompiledTrainStep: a data-parallel step's all-reduces over "
                                 f"{sorted(backends)} groups cannot be captured in a CUDA "
                                 f"graph; only NCCL's can")
            raise NotImplementedError("CompiledTrainStep: a captured data-parallel train step "
                                      "over NCCL is not ported (it needs several cards); "
                                      "make_sharded_train_step runs eagerly")
        self.device = opt_state["step"].device
        if self.device.type != "cuda":
            raise ValueError("CompiledTrainStep captures a CUDA graph: it takes params and "
                             "state on a CUDA device (make_train_step runs elsewhere)")
        for path, p in tree_paths(params):
            if not p.is_leaf or p.device != self.device:
                raise ValueError(f"param {'/'.join(path)}: a leaf tensor on {self.device} "
                                 "is needed")
            p.requires_grad_(True)
        self.params, self.opt_state = params, opt_state
        self.addresses = tensor_addresses(params, opt_state)
        self.body = make_train_body(cfg, base_lr=base_lr, warmup=warmup,
                                    total_steps=total_steps, max_grad_norm=max_grad_norm,
                                    weight_noise_std=weight_noise_std)
        self.generator = (torch.Generator(device=self.device) if weight_noise_std > 0.0
                          else None)
        self.host_step = int(opt_state["step"])
        self.warm = False
        self.batch = None
        self.metrics = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                        for k in ("loss", "ce", "aux", "grad_norm", "lr")}
        self.graph = None
        self.launches, self.launches_by_shape = {}, {}
        self.capture_seconds = None
        self.pool_bytes = None

    def _run(self):
        """The body on the captured tensors and buffers; its metrics copied
        into the static ones."""
        metrics = self.body(self.params, self.opt_state, self.batch, self.generator)
        with torch.no_grad():
            for k, t in self.metrics.items():
                t.copy_(metrics[k])

    def _capture(self):
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        counts = _launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self._run()
        except Exception as e:
            raise RuntimeError(f"CompiledTrainStep: the capture failed: {e}") from e
        finally:
            self.launches, self.launches_by_shape = _take_back(counts)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph

    def _check(self, params, opt_state, batch):
        if tensor_addresses(params, opt_state) != self.addresses:
            raise ValueError("CompiledTrainStep: params or state are not the tensors the step "
                             "was built on; load() them into the step's own")
        if self.batch is None:
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                          for k, v in batch.items()}
            return
        want = {k: (tuple(v.shape), v.dtype) for k, v in self.batch.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"CompiledTrainStep: the batch {got} is not the captured {want}")

    def __call__(self, params, opt_state, batch):
        self._check(params, opt_state, batch)
        for k, t in self.batch.items():
            t.copy_(batch[k])
        if not self.warm:
            self._seed()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()        # the allocator keeps its blocks per stream
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.warm = True
        else:
            if self.graph is None:
                self._capture()
            self._seed()
            self.graph.replay()
            _add_launches(self.launches, self.launches_by_shape)
        self.host_step += 1
        return self.params, self.opt_state, self.metrics

    def _seed(self):
        if self.generator is not None:
            self.generator.manual_seed(noise_seed(self.host_step))

    @torch.no_grad()
    def load(self, params, opt_state):
        """Copy ``params`` and ``opt_state`` (trees of the captured ones'
        nesting and shapes, on any device) into the captured tensors, and
        take the host's step from the state."""
        mine = dict(tree_paths({"p": self.params, "s": self.opt_state}))
        theirs = dict(tree_paths({"p": params, "s": opt_state}))
        if set(mine) != set(theirs):
            raise ValueError(f"load: other leaves {sorted(set(mine) ^ set(theirs))}")
        for path, t in mine.items():
            if tuple(theirs[path].shape) != tuple(t.shape):
                raise ValueError(f"load: {'/'.join(path)} has shape "
                                 f"{tuple(theirs[path].shape)}, the step's {tuple(t.shape)}")
            t.copy_(theirs[path])
        self.host_step = int(self.opt_state["step"])
        return self.params, self.opt_state


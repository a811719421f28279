"""Pipeline parallelism of the DiT and the DiM over a (data, stage[, model])
layout: GPipe.

Counterpart of `diffusion_models_collection_tpu/parallel/pipeline_parallel.py`.
The JAX package writes the pipeline as one SPMD program (a `shard_map` over
'stage' whose ticks hand activations on with `ppermute`, autodiff deriving
the backward). Here each stage is a process (`parallel/mesh.py`: rank
(d S + s) tp + m, the S stage ranks of a model group sharing its rows) that
holds its blocks only and hands activations on with explicit point-to-point
transfers (`isend`/`recv`; under gloo, whose `send` aborts on a CUDA
tensor, through host copies):

* `split_model` keeps blocks s depth / S .. (s + 1) depth / S - 1 of stage s
  under their single-device names (`StageBlocks`: `blocks.{i}.*`) and drops
  the others; the prologue (patch and position embedding, the timestep and
  label embedders) and the final layer stay whole on every stage.
* `Pipeline` runs a forward: the prologue on every stage, the rank's rows
  cut into M microbatches (`pp_microbatches`, default S), and the GPipe
  schedule of M + S - 1 ticks, stage s working on microbatch t - s at tick
  t: stage 0 takes microbatch t's tokens, every other stage receives the
  previous stage's activations, runs its blocks and sends them on; the
  last stage runs the final layer. A stage computes nothing on a bubble
  tick (the JAX program computes and discards), so a stage launches its
  blocks' kernels M times a step, each at the microbatch's rows. The
  conditioning of a microbatch comes from the replicated embedders on
  every stage, as in JAX's `pipe_fn`; it is not sent. The last stage's eps
  reaches every stage (an all-reduce of it and zeros, the JAX `psum` over
  'stage'), so every rank computes the same loss.
* The backward (`_PipelineFunction`): the forward keeps each microbatch's
  stage graph; the backward runs the schedule in reverse, each stage's
  microbatch graph given the cotangent received from stage s + 1 (the last
  stage: its rows of the eps cotangent, which it alone uses, so the eps
  sent to every stage returns one cotangent, not S), its input's gradient
  sent to stage s - 1. Every rank runs it (each uses the eps it returns),
  in one order. The gradients of the prologue's tokens (stage 0) and of
  the conditioning (every stage) flow on to the embedders.

Gradients (`parallel/plan.py`, at the update): a block's average over its
'data' group; the replicated parameters' (the patch embedding's on stage 0,
the final layer's on the last, the conditioning's embedders' on every
stage) sum over 'stage', then average over 'data'. The clip counts each
block's gradient once (its squares summed over 'stage') and each
replicated gradient once. With `tensor_parallel` a stage's blocks are cut
by `parallel/tensor_parallel.py` inside it (the DiT only, as in JAX).

Dropout: a sharded step is the one-device step. A stage runs only its
blocks, and M microbatch calls of a layer would draw M masks where one
device draws one, so each train-mode forward first replays the one-device
draws (`Pipeline.replay`): for every block in order, each dropout's global
mask and each attention call's seed, from the generators every rank seeds
alike. A stage keeps those of its blocks (its data rank's rows) and drops
the rest; microbatch m takes rows m mb .. of each kept mask
(`Dropout.replay_row0`), and its attention calls the dropout kernels (K2,
K3) with the step's seed at `batch0` = d B_local + m mb, the global row of
its first row (E7's key). A rank pays the one-device step's draws, as a
data-parallel rank does.

The blocks run without `remat`, as the JAX pipeline builds them
(`pipeline_parallel.py:210-222` there). Checkpoints gather the stages'
blocks to the single-device names (`parallel/plan.py`), so a pipeline
checkpoint resumes in one process and the reverse.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.dit import SelfAttention
from ..models.layers import Dropout
from ..ops.attention import draw_seed
from .data_parallel import DataParallelApply
from .mesh import Layout, staged_on_host


class StageBlocks(nn.Module):
    """A stage's blocks under their single-device indices (state-dict names
    `blocks.{i}.*`), iterated in order."""

    def __init__(self, blocks: Dict[int, nn.Module]):
        super().__init__()
        for index, block in blocks.items():
            self.add_module(str(index), block)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def indices(self) -> List[int]:
        return [int(k) for k in self._modules]


def stage_blocks(depth: int, pp: int, stage: int) -> range:
    """The blocks of stage `stage` of `pp`."""
    per = depth // pp
    return range(stage * per, (stage + 1) * per)


def check_pipeline(model: nn.Module, pp: int, tp: int = 1) -> None:
    """The JAX trainer's rules for `model` on `pp` stages of `tp` 'model'
    ranks, with its messages: a model that runs as a pipeline says so with
    its own `check_pipeline_parallel`, which holds its rules."""
    check = getattr(model, "check_pipeline_parallel", None)
    if check is None:
        raise ValueError("pipeline_parallel supports the DiT and DiM "
                         f"backbones (got {type(model).__name__})")
    check(pp, tp)


def check_depth(name: str, depth: int, pp: int) -> None:
    """The blocks split evenly over the stages (the JAX message)."""
    if depth % pp:
        raise ValueError(f"{name} depth {depth} not divisible by "
                         f"pipeline_parallel={pp}")


def check_microbatches(rows: int, microbatches: int, what: str) -> None:
    """A data-parallel rank's `rows` must split into the microbatches (the
    JAX pipeline reshapes them (M, rows / M) and fails otherwise)."""
    if rows % microbatches:
        raise ValueError(f"{what}: {rows} rows a data-parallel rank do not "
                         f"split into pp_microbatches={microbatches} "
                         "microbatches")


def split_model(model: nn.Module, pp: int, stage: int) -> nn.Module:
    """`model` with only stage `stage`'s blocks (in place), under their
    single-device names; the other blocks' parameters are dropped."""
    check_pipeline(model, pp)
    keep = stage_blocks(len(model.blocks), pp, stage)
    model.depth = len(model.blocks)
    model.blocks = StageBlocks({i: model.blocks[i] for i in keep})
    model.remat = False  # the JAX pipeline's blocks have no remat
    return model


def draw_sites(block: nn.Module) -> list:
    """The modules of `block` that draw in a train-mode forward, in the
    forward's order (registration order): attention calls with dropout,
    which draw a seed each, and dropouts."""
    return [m for m in block.modules()
            if (isinstance(m, SelfAttention) and m.dropout > 0)
            or (isinstance(m, Dropout) and m.p > 0)]


# ---------------------------------------------------------- hand-offs
def send(tensor: torch.Tensor, dst: int, group, works: list) -> None:
    """Start sending `tensor` to global rank `dst` (under gloo a CUDA
    tensor from a host copy); `works` keeps the request and its buffer."""
    tensor = tensor.detach().contiguous()
    if staged_on_host(tensor, group):
        tensor = tensor.cpu()
    works.append((dist.isend(tensor, dst, group=group), tensor))


def recv(like: torch.Tensor, shape, src: int, group) -> torch.Tensor:
    """A tensor of `shape` and `like`'s type and device received from
    global rank `src`."""
    staged = staged_on_host(like, group)
    buf = torch.empty(shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    dist.recv(buf, src, group=group)
    return buf.to(like.device) if staged else buf


def wait_all(works: list) -> None:
    for work, _ in works:
        work.wait()
    works.clear()


class Pipeline:
    """apply(x, t, y=None) -> eps on the rank's rows of a DiT or DiM stage
    (`split_model`'s) over `layout`, in `microbatches` microbatches (see
    the module docstring)."""

    def __init__(self, model: nn.Module, layout: Layout, microbatches: int):
        self.model, self.layout = model, layout
        self.microbatches = int(microbatches)
        self.blocks = list(model.blocks)
        self.placed = [m for b in self.blocks for m in b.modules()
                       if isinstance(m, (SelfAttention, Dropout))]
        lay = layout
        self.group = lay.stage_group
        rank = dist.get_rank()
        self.prev, self.next = rank - lay.tp, rank + lay.tp
        self.first = lay.pp_rank == 0
        self.last = lay.pp_rank == lay.pp - 1

    # ------------------------------------------------------------ draws
    def replay(self, rows: int, tokens: int, device) -> None:
        """The one-device forward's draws, in its order: each block's
        attention seeds and dropout masks (of the global batch); this
        stage's blocks keep theirs (their rank's rows)."""
        sites = [draw_sites(b) for b in self.blocks]
        template = sites[0]
        own = dict(zip(self.model.blocks.indices(), sites))
        for index in range(self.model.depth):
            mine = own.get(index)
            for k, site in enumerate(template):
                if isinstance(site, SelfAttention):
                    value = draw_seed()
                    if mine is not None:
                        mine[k].replayed_seed = value
                else:
                    if site.width is None:
                        raise ValueError("a pipeline stage replays only "
                                         "dropouts that know their width")
                    keep = site.draw((rows, tokens, site.width), device)
                    if mine is not None:
                        mine[k].replayed = keep

    def clear(self) -> None:
        for module in self.placed:
            if isinstance(module, Dropout):
                module.replayed = None
            else:
                module.replayed_seed = module.batch0 = None

    def place(self, row0: int, rows: int) -> None:
        """Microbatch rows row0 .. of the rank's `rows`: their place in the
        kept masks and in the global batch (the attention's `batch0`)."""
        batch0 = self.layout.dp_rank * rows + row0
        for module in self.placed:
            if isinstance(module, Dropout):
                module.replay_row0 = row0
            else:
                module.batch0 = batch0

    # --------------------------------------------------------- schedule
    def run(self, tokens, c, keep: bool):
        """The forward schedule on (tokens, c) of the rank's rows; with
        `keep`, each microbatch's graph is kept for `backward`. Returns the
        final layer's tokens (float32) of the rank's rows, on every stage,
        and the kept graphs."""
        lay, M = self.layout, self.microbatches
        rows = tokens.shape[0]
        mb = rows // M
        shape = (mb, *tokens.shape[1:])
        ins, outs, finals, works = [None] * M, [None] * M, [None] * M, []
        for tick in range(M + lay.pp - 1):
            m = tick - lay.pp_rank
            if not 0 <= m < M:
                continue  # a bubble: nothing to compute
            cut = slice(m * mb, (m + 1) * mb)
            if self.first:
                h = tokens[cut]
            else:
                h = recv(tokens, shape, self.prev, self.group)
                if keep:
                    h.requires_grad_(True)
            self.place(m * mb, rows)
            c_m = c[cut]
            x_in = h
            for block in self.blocks:
                h = block(h, c_m)
            if keep:
                ins[m], outs[m] = x_in, h
            if self.last:
                finals[m] = self.model.final_layer(h, c_m).to(torch.float32)
            else:
                send(h, self.next, self.group, works)
        wait_all(works)
        if self.last:
            eps = torch.cat([f.detach() for f in finals])
        else:
            width = self.model.final_layer.linear.out_features
            eps = torch.zeros((rows, tokens.shape[1], width),
                              dtype=torch.float32, device=tokens.device)
        # the last stage's eps on every stage (the JAX psum over 'stage')
        dist.all_reduce(eps, group=self.group)
        return eps, (ins, outs, finals)

    def backward(self, graphs, g_eps):
        """The reverse schedule: each microbatch's stage graph under the
        cotangent from stage s + 1 (the last stage: its rows of `g_eps`),
        the input's gradient sent to stage s - 1."""
        ins, outs, finals = graphs
        M = self.microbatches
        mb = g_eps.shape[0] // M
        works = []
        for m in reversed(range(M)):
            if self.last:
                torch.autograd.backward(finals[m],
                                        g_eps[m * mb:(m + 1) * mb])
            else:
                g = recv(outs[m], outs[m].shape, self.next, self.group)
                torch.autograd.backward(outs[m], g)
            if not self.first:
                send(ins[m].grad, self.prev, self.group, works)
        wait_all(works)

    def __call__(self, x: torch.Tensor, t: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        model = self.model
        check_microbatches(x.shape[0], self.microbatches,
                           "a pipeline-parallel forward")
        tokens, c = model.embed(x, t, y)
        try:
            if model.training:
                self.replay(x.shape[0], tokens.shape[1], tokens.device)
            if torch.is_grad_enabled() and (tokens.requires_grad
                                            or c.requires_grad):
                eps = _PipelineFunction.apply(self, tokens, c)
            else:
                eps, _ = self.run(tokens, c, keep=False)
        finally:
            self.clear()
        return model.output(eps)


class _PipelineFunction(torch.autograd.Function):
    """The pipeline's forward schedule, its graphs kept, and the reverse
    schedule as its backward (every rank runs both, in one order). The
    gradients of the stage's parameters accumulate inside the backward;
    it returns those of the tokens (stage 0's; zeros on the other stages,
    so every stage's patch embedding holds a gradient) and of the
    conditioning."""

    @staticmethod
    def forward(ctx, pipe, tokens, c):
        tokens = tokens.detach().requires_grad_(True)
        c = c.detach().requires_grad_(True)
        with torch.enable_grad():
            eps, graphs = pipe.run(tokens, c, keep=True)
        ctx.pipe, ctx.graphs, ctx.leaves = pipe, graphs, (tokens, c)
        return eps

    @staticmethod
    def backward(ctx, g_eps):
        tokens, c = ctx.leaves
        with torch.enable_grad():
            ctx.pipe.backward(ctx.graphs, g_eps.contiguous())
        ctx.graphs = None
        g_tokens = (tokens.grad if tokens.grad is not None
                    else torch.zeros_like(tokens))
        g_c = c.grad if c.grad is not None else torch.zeros_like(c)
        return None, g_tokens, g_c


def make_pipeline_apply(model: nn.Module, layout: Layout,
                        microbatches: Optional[int] = None) -> Pipeline:
    """apply(x, t, y=None) -> eps of a stage of `model` (cut by
    `split_model`) over `layout`, in `microbatches` microbatches (default
    the stage count), as JAX `make_pipeline_apply`."""
    return Pipeline(model, layout, microbatches or layout.pp)


def make_sampling_apply(model: nn.Module, layout: Layout,
                        microbatches: Optional[int] = None):
    """apply(x, t, y=None) -> eps of every row of x (the same on every
    rank) through the pipeline: each data rank's rows (`num_samples` split
    over 'data', as the JAX shard_map splits them), gathered back
    (`data_parallel.DataParallelApply`)."""
    split = DataParallelApply(make_pipeline_apply(model, layout,
                                                  microbatches), layout)

    def apply(x, t, y=None, **_):
        with torch.no_grad():
            return split(x, t, y)

    return apply

"""Pipeline parallelism: the stages of the decoder stack as ranks.

Port of the JAX package's ``parallel/pipeline.py``. JAX runs the pipeline
as one GSPMD program: a scan over ticks in which every stage applies its
layers at once and ``roll`` hands each stage's output to the next
(``PipelinedStack`` :248, ``_PipelineTick`` :202). Here each stage is a
process of the mesh's pp group, and activations pass between neighbours
point to point. The math is JAX's: every microbatch runs through the same
layers in the same order, the loss is the whole batch's, and the
gradients are summed over the microbatches.

- **Placement** (:func:`stage_chunks`). The decoder's ``num_layers`` are
  cut into ``pp · v`` chunks of equal size (``v`` the virtual degree;
  ``num_layers % (pp · v)`` must be 0, JAX :282-284); chunk ``g`` runs on
  stage ``g mod pp``, the reference's interleaved placement and JAX's
  sequential-chunk layout. A microbatch passes the stage ring ``v`` times;
  the last stage sends chunk ``pp - 1``'s output back to stage 0.
- **Schedule** (:func:`schedule`, :class:`Pipeline`). Fill-drain, the
  JAX scan's own order: every forward, then every backward in reverse.
  The forwards are ordered by JAX's tick (microbatch ``m`` enters chunk
  ``g`` at tick ``m + g``, as in the streamed scan), each rank running
  its own in that order. Sends never block and a receive waits only for
  a send earlier in that order, so no order of the ranks' progress
  deadlocks on gloo's blocking receives, and the order is the same every
  run. A received activation is a leaf that requires grad; its ``.grad``
  goes back upstream.
- **Transport** (:class:`Transport`). NCCL takes device tensors through
  ``batch_isend_irecv``. On gloo (ranks that share a card, or CPU ranks)
  a CUDA tensor is staged through pinned host memory, as
  ``context_parallel.ring_shift`` stages its blocks.
- **Remaps** (:func:`sequential_params_to_pipeline`,
  :func:`pipeline_params_to_sequential`,
  :func:`maybe_pipeline_params_to_sequential`): numpy copies of JAX's
  (:105, :142, :172) over flax-style nested dicts, for both virtual
  layouts: the streamed one (one ``pipe`` tree of ``v · pp`` rows, row
  ``g`` = chunk ``g``) and the sequential-chunk one (one ``pipe_chunk{j}``
  tree per pass, stage ``p`` of pass ``j`` = chunk ``j · pp + p``).

1F1B, pp × cp and a CUDA-IPC transport are not here (ROADMAP).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Pipeline", "Transport", "maybe_pipeline_params_to_sequential",
           "pipeline_params_to_sequential", "schedule",
           "sequential_params_to_pipeline", "stage_chunks", "stage_layers"]

# --------------------------------------------------------------- the remaps

_SEQ_PREFIX = "gpt/layers/layer/"
_PIPE_PREFIX = "gpt/layers/pipe/stages/layers/layer/"
_VPIPE_SCOPE = "pipe_chunk{j}"
_VPIPE_RE = "gpt/layers/" + _VPIPE_SCOPE + "/stages/layers/layer/"


def _flatten(variables) -> Tuple[Dict[str, object], bool]:
    """``{"a/b/c": leaf}`` of a nested mapping (its ``params`` entry when
    it has one), and whether it had one."""
    wrap = "params" in variables
    params = variables["params"] if wrap else variables
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(params, "")
    return flat, wrap


def _unflatten(flat: Dict[str, object], wrap: bool) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return {"params": tree} if wrap else tree


def sequential_params_to_pipeline(variables, pp: int, virtual_pp: int = 1,
                                  stream: bool = True):
    """A sequential param tree (``gpt/layers/layer/*`` on a leading
    ``[num_layers]`` axis) in the pipeline layout: ``[pp,
    layers_per_stage]`` leading axes under ``gpt/layers/pipe/...``; with
    virtual stages either the streamed layout (``stream``: the plain
    layout with ``v · pp`` rows) or the sequential-chunk one (one ``[pp,
    layers_per_chunk]`` tree per pass). JAX resolves ``stream`` from
    ``FLEETX_VPP_STREAM``, default on; here it is the caller's."""
    if virtual_pp > 1 and stream:
        return sequential_params_to_pipeline(variables, pp * virtual_pp, 1)
    flat, wrap = _flatten(variables)
    out = {}
    for k, val in flat.items():
        if not k.startswith(_SEQ_PREFIX):
            out[k] = val
            continue
        val = np.asarray(val)
        suffix = k[len(_SEQ_PREFIX):]
        n = val.shape[0]
        if virtual_pp <= 1:
            out[_PIPE_PREFIX + suffix] = val.reshape(
                (pp, n // pp) + val.shape[1:])
            continue
        lpc = n // (pp * virtual_pp)
        chunks = val.reshape((virtual_pp * pp, lpc) + val.shape[1:])
        for j in range(virtual_pp):
            out[_VPIPE_RE.format(j=j) + suffix] = chunks[j * pp:(j + 1) * pp]
    return _unflatten(out, wrap)


def pipeline_params_to_sequential(variables):
    """Inverse of :func:`sequential_params_to_pipeline` on every layout:
    the chunk and stage axes merged back into ``[num_layers]``."""
    flat, wrap = _flatten(variables)
    out, vchunks = {}, {}
    pattern = re.compile("^" + re.escape(_VPIPE_RE.format(j="@")).replace(
        "@", r"(\d+)") + "(.*)")
    for k, v in flat.items():
        m = pattern.match(k)
        if m:
            vchunks.setdefault(m.group(2), {})[int(m.group(1))] = v
        elif k.startswith(_PIPE_PREFIX):
            v = np.asarray(v)
            out[_SEQ_PREFIX + k[len(_PIPE_PREFIX):]] = v.reshape(
                (v.shape[0] * v.shape[1],) + v.shape[2:])
        else:
            out[k] = v
    for suffix, by_chunk in vchunks.items():
        stacked = np.concatenate([np.asarray(by_chunk[j])
                                  for j in sorted(by_chunk)], axis=0)
        out[_SEQ_PREFIX + suffix] = stacked.reshape(
            (stacked.shape[0] * stacked.shape[1],) + stacked.shape[2:])
    return _unflatten(out, wrap)


def maybe_pipeline_params_to_sequential(variables):
    """:func:`pipeline_params_to_sequential` when the tree holds
    pipeline-layout params; the tree itself otherwise."""
    flat, _ = _flatten(variables)
    marker = "/" + _VPIPE_SCOPE.format(j="")
    if any(k.startswith(_PIPE_PREFIX) or marker in k for k in flat):
        return pipeline_params_to_sequential(variables)
    return variables


# ------------------------------------------------------------- the placement

def stage_chunks(num_layers: int, pp: int, virtual_pp: int = 1
                 ) -> List[range]:
    """The layers of each of the ``pp · v`` chunks, in chunk order; chunk
    ``g`` runs on stage ``g mod pp``. ``ValueError`` unless ``pp · v``
    divides ``num_layers`` (JAX :282-284)."""
    v = max(int(virtual_pp), 1)
    if num_layers % (pp * v):
        raise ValueError(f"num_layers {num_layers} % (pp {pp} * virtual "
                         f"{v}) != 0")
    lpc = num_layers // (pp * v)
    return [range(g * lpc, (g + 1) * lpc) for g in range(pp * v)]


def stage_layers(num_layers: int, pp: int, virtual_pp: int,
                 stage: int) -> List[int]:
    """The global ids of the layers stage ``stage`` holds, in the order
    its chunks run."""
    return [i for g, layers in enumerate(stage_chunks(num_layers, pp,
                                                      virtual_pp))
            if g % pp == stage for i in layers]


def schedule(num_microbatches: int, chunks: int) -> List[Tuple[int, int]]:
    """Every forward ``(microbatch, chunk)`` of one step in the order the
    ranks run them: by tick ``m + g`` (JAX's streamed scan), then by
    chunk. A rank runs its own chunks' entries in this order, and the
    backwards in the reverse one."""
    ops = [(m, g) for m in range(num_microbatches) for g in range(chunks)]
    return sorted(ops, key=lambda op: (op[0] + op[1], op[1]))


# ------------------------------------------------------------ the transport

class Transport:
    """Point-to-point sends and receives between the stages of one pp
    group. Sends return at once (their buffers are held until
    :meth:`wait_sends`); a receive blocks until its tensor is here."""

    def __init__(self, group):
        self.group = group
        self.nccl = dist.get_backend(group) == "nccl"
        self._sends: List[tuple] = []
        if self.nccl:
            # batch_isend_irecv needs every rank of the group in the
            # group's first NCCL call: make that call a collective
            dist.barrier(group=group)

    def send(self, t: torch.Tensor, dst: int) -> None:
        """Send ``t`` to global rank ``dst``."""
        t = t.detach().contiguous()
        if self.nccl:
            work = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, dst, self.group)])
            self._sends.append((work, t))
            return
        if t.is_cuda:  # gloo sends host memory only: stage through pinned
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)  # waits for the stream: the bytes are final
            t = host
        self._sends.append(([dist.isend(t, dst, group=self.group)], t))

    def recv(self, shape: Sequence[int], dtype: torch.dtype, src: int,
             device: torch.device) -> torch.Tensor:
        """The next tensor of ``shape`` and ``dtype`` from global rank
        ``src``, on ``device``."""
        if self.nccl:
            out = torch.empty(shape, dtype=dtype, device=device)
            for work in dist.batch_isend_irecv(
                    [dist.P2POp(dist.irecv, out, src, self.group)]):
                work.wait()
            return out
        cuda = torch.device(device).type == "cuda"
        host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        dist.irecv(host, src, group=self.group).wait()
        return host.to(device, non_blocking=True) if cuda else host

    def wait_sends(self) -> None:
        """Block until every send has left (its buffer may then go)."""
        for works, _ in self._sends:
            for work in works:
                work.wait()
        self._sends.clear()


class Pipeline:
    """The fill-drain schedule of one stage of ``mesh``'s pipeline over
    ``virtual_pp`` passes."""

    def __init__(self, mesh, virtual_pp: int = 1):
        self.mesh = mesh
        self.pp, self.v = mesh.pp, max(int(virtual_pp), 1)
        self.chunks = self.pp * self.v
        self.transport = Transport(mesh.pp_group)

    def owner(self, chunk: int) -> int:
        """The global rank that runs ``chunk`` in this rank's pipeline."""
        return self.mesh.pp_ranks[chunk % self.pp]

    def run(self, num_microbatches: int,
            stage: Callable[[int, int, Optional[torch.Tensor]],
                            torch.Tensor],
            shape: Sequence[int], dtype: torch.dtype, device,
            train: bool) -> torch.Tensor:
        """One step of the schedule. ``stage(m, g, x)`` runs chunk ``g`` on
        microbatch ``m``: ``x`` is None for chunk 0 (the stage embeds the
        tokens), else the previous chunk's output of ``shape`` and
        ``dtype``; the last chunk returns the microbatch's scalar share of
        the loss, every other chunk its output. With ``train`` the
        backwards follow the forwards. Returns the sum of this rank's
        loss shares (0 on a stage without the last chunk)."""
        mine = [(m, g) for m, g in schedule(num_microbatches, self.chunks)
                if self.owner(g) == self.mesh.rank]
        last = self.chunks - 1
        loss = torch.zeros((), device=device)
        held = []
        for m, g in mine:
            x = None
            if g > 0:
                x = self.transport.recv(shape, dtype, self.owner(g - 1),
                                        device).requires_grad_(train)
            y = stage(m, g, x)
            if g < last:
                self.transport.send(y, self.owner(g + 1))
            else:
                loss += y.detach()
            if train:
                held.append((g, x, y))
        for g, x, y in reversed(held):
            if g == last:
                torch.autograd.backward(y)
            else:
                dy = self.transport.recv(y.shape, y.dtype, self.owner(g + 1),
                                         device)
                torch.autograd.backward(y, dy)
            if g > 0:
                self.transport.send(x.grad, self.owner(g - 1))
        self.transport.wait_sends()
        return loss

"""The train step (one backward pass, then the G and D Adam updates and the
spectral ``u`` update), K of them in one call, and the eval step (the prior
rollout and its metrics).

Port of ``video_prediction_tpu/train/step.py#make_train_step`` and
``#make_eval_step``, on one device or data parallel over a process group
(``group``: one process per GPU, ``parallel/``). ``compute_losses`` places the detaches so
that one backward of ``g_loss + d_loss`` gives each side its own gradients,
as the reference's joint ``sess.run`` does. With ``compute_dtype`` bfloat16
the parameters, their gradients and Adam's moments stay fp32, and there is
no loss scaling, as in the JAX package.

``steps_per_call`` K > 1 is the JAX package's fused dispatch (``lax.scan``
over batches stacked ``[K, B, ...]``): one call takes K optimizer steps and
returns the last step's scalars. Here the K steps are one Python function,
``MultiStep.steps``, which reads the step as a 0-d tensor that it advances
in place (the schedules and Adam's learning rate stay on the device). On
the CPU a call runs it eagerly: that is the plain version. On CUDA:

- the first call runs it eagerly on a side stream: K real steps, which also
  set up cuDNN, the kernels' shared-memory attributes, Adam's state and the
  allocator;
- the second call captures it as one ``torch.cuda.CUDAGraph`` of K steps
  (capture runs nothing: the step and the launch counters do not move)
  and replays it;
- every call copies the batches into the graph's static ``[K, B, ...]``
  buffers and draws the K steps' noise from ``ts.rng`` into static noise
  buffers, outside the graph, in the order K eager steps draw it; then it
  runs or replays the steps.

A capture or replay error raises: there is no eager fallback. The train
state must have Adams built for K > 1 (``state.make_optimizers``). The
kernel wrappers count their launches as Python calls, so the capture's
counts are taken back out and added once per replay. Where the generator
cell is recomputed in the backward pass (``models/savp.py#recomputes``)
the recompute runs inside ``total.backward()``, so it is captured with the
step, and a step counts each forward kernel twice.

Data parallel (``group``, the counterpart of the JAX step's mesh
``in_shardings`` and the gradient ``psum`` XLA emits from them): each rank
takes its rows of the global batch, and its slice of the noise drawn for
the global batch (``ts.rng`` is seeded alike on every rank, so every rank
draws the same global noise, ``parallel/mesh.py#shard_noise``). After the
backward every rank mean-reduces all gradients, and the step's scalars, in
one flat all-reduce, then applies the same Adam update, so the ranks'
parameters and spectral ``u``s stay equal and a step of W ranks equals the
one-process step on the whole batch. Plain collectives, not
``DistributedDataParallel``: one backward feeds two Adams and some leaves
get no gradient, which DDP would need ``find_unused_parameters`` for, and
that does not capture into a CUDA graph. With NCCL the all-reduce is
captured into ``MultiStep``'s graph (its eager first call also creates the
communicator); gloo collectives do not capture, so a ``MultiStep`` on CUDA
tensors under gloo raises.

Spatial partitioning (``spatial``, a ``parallel/mesh.py#SpatialMesh``; the
JAX step's ``model`` mesh axis, ``_lazy_spatial_jit``): ``batch`` holds
this rank's rows of its data coordinate's samples, the noise is sliced by
the data coordinate and size (the k ranks of a spatial group draw the same
``use_gt_u``, ``eps_q``, ``z_p`` and ``clip_start``), and the losses run in
a ``spatial_context``, where each rank's loss is its share of its group's
(``models/base.py``). The one flat all-reduce over ``group`` (the world)
then sums the gradients and scalars over the spatial group and means them
over the data group, divided by the data size. Every halo, statistic and
gather inside the step is an all-reduce of its own (``parallel/spatial.py``),
captured into ``MultiStep``'s graph under NCCL like the gradients'.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from video_prediction_torch import kernels as K
from video_prediction_torch.parallel.mesh import SpatialMesh, all_reduce_mean_, shard_noise, spatial_context
from video_prediction_torch.train import schedules
from video_prediction_torch.train.state import TrainState
from video_prediction_torch.utils import trace

Scalars = Dict[str, torch.Tensor]


def _update(ts: TrainState, batch: Dict[str, torch.Tensor], noise: Optional[Dict[str, Any]],
            step: int | torch.Tensor, group: Optional[dist.ProcessGroup] = None,
            spatial: Optional[SpatialMesh] = None, phases=trace.NO_PHASES) -> Scalars:
    """One train step at ``step`` (an int, or a 0-d tensor on the batch's
    device) on ``batch`` with ``noise`` (drawn from ``ts.rng`` when None):
    the backward pass, the mean over ``group``'s ranks of the gradients and
    scalars (under ``spatial``: the sum over the spatial group, the mean
    over the data group), both Adam updates and the spectral ``u``. Returns
    the step's 0-d loss tensors; ``ts.step`` is left to the caller.
    ``phases`` (``utils/trace.py#StepPhases``) records a device event at the
    step's start and after each phase: ``losses``, ``backward`` (the
    recompute inside it), ``allreduce`` where there is a group, ``update``
    (both Adams and the ``u`` copy)."""
    phases.mark("start")
    with spatial_context(spatial):
        total, aux = ts.model.compute_losses(batch, step, noise=noise, generator=ts.rng)
    phases.mark("losses")
    optimizers = [opt for opt in (ts.opt_g, ts.opt_d) if opt is not None]
    for opt in optimizers:
        opt.zero_grad(set_to_none=True)
    total.backward()
    phases.mark("backward")
    grads = []
    for opt in optimizers:
        for param_group in opt.param_groups:
            for p in param_group["params"]:
                if p.grad is None:  # optax updates every leaf, with a zero gradient if need be
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
    scalars = {
        "g_loss": aux["g_loss"].detach(),
        "d_loss": aux["d_loss"].detach(),
        **{f"g/{k}": v.detach() for k, v in aux["g_losses"].items()},
        **{f"d/{k}": v.detach() for k, v in aux["d_losses"].items()},
    }
    if group is not None:  # every rank the same layout: the zero gradients above first
        all_reduce_mean_(grads + list(scalars.values()), group, spatial.data_size if spatial else None)
        phases.mark("allreduce")
    lr = schedules.learning_rate(step, ts.model.hparams)  # optax reads the count before it increments
    for opt in optimizers:
        for param_group in opt.param_groups:
            if torch.is_tensor(param_group["lr"]):
                param_group["lr"].fill_(lr)  # in place: a captured graph reads this tensor
            else:
                param_group["lr"] = lr
        opt.step()
    with torch.no_grad():
        for key, layers in aux["new_state"].get("spectral", {}).items():
            disc = ts.model.discriminator[key]
            for layer, u in layers.items():
                getattr(disc, layer).u.copy_(u)
    phases.mark("update")
    return scalars


def _data_axis(group: dist.ProcessGroup, spatial: Optional[SpatialMesh]) -> Tuple[int, int]:
    """(data coordinate, data size) of this rank."""
    if spatial is not None:
        return spatial.data_rank, spatial.data_size
    return dist.get_rank(group), dist.get_world_size(group)


def _rank_noise(ts: TrainState, images: torch.Tensor, noise: Optional[Dict[str, Any]],
                group: dist.ProcessGroup, spatial: Optional[SpatialMesh] = None) -> Dict[str, Any]:
    """This rank's slice of the step noise: ``noise`` as drawn for the global
    batch, or drawn so from ``ts.rng`` when None (``images`` ``[B, T, ...]``,
    this rank's B rows), by the data coordinate. Under
    ``schedule_sampling_exact`` the slice also holds ``use_gt_rank``, the
    ranks of its ``use_gt_u`` columns in the global rows, and
    ``use_gt_batch``, the global batch: every rank ranks the same uniforms,
    so the mask is the global batch's (round(p * B) samples a timestep over
    the ranks together, as the JAX mesh step draws it) without a collective,
    and ``p`` is taken at the step, inside a ``MultiStep``'s graph too."""
    rank, size = _data_axis(group, spatial)
    if noise is None:
        noise = ts.model.draw_noise(images.shape[0] * size, images.shape[1], ts.rng, images.device)
    if ts.model.hparams.schedule_sampling_exact:
        noise = dict(noise, use_gt_rank=schedules.use_gt_ranks(noise["use_gt_u"]),
                     use_gt_batch=noise["use_gt_u"].shape[1])
    return shard_noise(noise, rank, size)


def _check_data_parallel(group: Optional[dist.ProcessGroup], spatial: Optional[SpatialMesh] = None) -> None:
    if spatial is not None and group is None:
        raise ValueError("spatial partitioning needs the process group that its spatial groups divide")


def make_train_step(model, steps_per_call: int = 1, group: Optional[dist.ProcessGroup] = None,
                    spatial: Optional[SpatialMesh] = None) -> Callable[..., Scalars]:
    """The train step of ``model``, updating ``ts`` in place and returning the
    0-d loss tensors ``g_loss``, ``d_loss``, ``g/<term>`` and ``d/<term>``.

    ``steps_per_call`` 1: ``train_step(ts, batch, noise=None)`` takes one
    step; ``noise`` as ``model.draw_noise`` gives it, drawn from ``ts.rng``
    when None. K > 1: a ``MultiStep``, ``train_step(ts, batches,
    noises=None)`` on batches stacked ``[K, B, ...]``, K steps and the last
    one's scalars; ``noises`` a list of K such dicts. ``group``: data
    parallel over that process group; ``batch`` holds this rank's rows,
    ``noise`` is drawn for the global batch (B x the world size rows) and the
    scalars are the global means. ``spatial``: spatial partitioning within
    ``group`` (the module docstring); ``batch`` then holds this rank's rows
    of its data coordinate's samples, and ``noise`` is drawn for the global
    batch of B x the data size samples."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
    _check_data_parallel(group, spatial)
    if steps_per_call > 1:
        return MultiStep(steps_per_call, group, spatial)

    def train_step(ts: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[Dict[str, Any]] = None) -> Scalars:
        if group is not None:
            noise = _rank_noise(ts, batch["images"], noise, group, spatial)
        scalars = _update(ts, batch, noise, ts.step, group, spatial, trace.phases_for(batch["images"].device))
        ts.step += 1
        return scalars

    return train_step


def _launch_delta(before: Dict[str, Dict[str, int]], after: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    return {name: {dt: n - before.get(name, {}).get(dt, 0) for dt, n in by_dtype.items()}
            for name, by_dtype in after.items()}


class MultiStep:
    """K train steps a call (see the module docstring). After a call,
    ``scalars_by_step`` ``[K, len(keys)]`` holds every step's scalars (the
    call returns the last row by ``keys``); ``calls`` counts the calls;
    after the capture ``capture_s`` is its host time in seconds and
    ``graph_launches`` the kernel launches of one replay (wrapper -> dtype
    -> launches). ``group``: data parallel, as ``make_train_step``'s.
    ``keep_graph``, set before the capture, keeps the captured
    ``cudaGraph_t`` so that ``dump_graph`` can list its nodes. The capture
    takes each step's phase events (``_update``) into the graph.

    Spans (``utils/trace.py``): ``multistep.call`` with its children
    ``multistep.noise``, ``multistep.copy_in`` and ``multistep.replay``;
    the set-up spans ``multistep.eager`` and ``multistep.capture``, whose
    duration ``capture_s`` is."""

    def __init__(self, steps_per_call: int, group: Optional[dist.ProcessGroup] = None,
                 spatial: Optional[SpatialMesh] = None):
        self.k = steps_per_call
        self.group = group
        self.spatial = spatial
        self.keep_graph = False
        self.calls = 0
        self.keys: List[str] = []
        self.scalars_by_step: Optional[torch.Tensor] = None
        self.capture_s: Optional[float] = None
        self.graph_launches: Dict[str, Dict[str, int]] = {}
        self._ts: Optional[TrainState] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: Optional[Tuple[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]], torch.Tensor]] = None
        self._out: Optional[torch.Tensor] = None  # the graph's scalars_by_step
        self._phases = trace.NO_PHASES  # the graph's phase events

    def steps(self, ts: TrainState, batches: Dict[str, torch.Tensor], noises: List[Dict[str, Any]],
              step: torch.Tensor, phases=trace.NO_PHASES) -> torch.Tensor:
        """The K steps: step k on slot k of ``batches`` and ``noises`` at
        ``step``, which it advances by one after each, each with its
        ``phases`` events. Returns their scalars stacked ``[K, len(keys)]``
        and sets ``keys``."""
        rows = []
        for k in range(self.k):
            scalars = _update(ts, {key: v[k] for key, v in batches.items()}, noises[k], step, self.group,
                              self.spatial, phases)
            step.add_(1)
            rows.append(torch.stack([v.float() for v in scalars.values()]))
        self.keys = list(scalars)
        return torch.stack(rows)

    def __call__(self, ts: TrainState, batches: Dict[str, torch.Tensor],
                 noises: Optional[List[Dict[str, Any]]] = None) -> Scalars:
        bad = {key: tuple(v.shape) for key, v in batches.items() if v.ndim == 0 or v.shape[0] != self.k}
        if bad:
            raise ValueError(f"steps_per_call={self.k} takes batches stacked [{self.k}, B, ...], got {bad}")
        if noises is not None and len(noises) != self.k:
            raise ValueError(f"steps_per_call={self.k} takes {self.k} noise dicts, got {len(noises)}")
        with trace.span("multistep.call"):
            images = batches["images"]
            with trace.span("multistep.noise"):
                if self.group is not None:  # the global batch's noise, this rank's slice
                    noises = [_rank_noise(ts, images[k], None if noises is None else noises[k], self.group,
                                          self.spatial) for k in range(self.k)]
                elif noises is None:
                    noises = [ts.model.draw_noise(images.shape[1], images.shape[2], ts.rng, images.device)
                              for _ in range(self.k)]
            if images.device.type == "cuda":
                table = self._cuda_call(ts, batches, noises)
            else:
                table = self.steps(ts, batches, noises, torch.tensor(ts.step, device=images.device))
            ts.step += self.k
            self.calls += 1
            self.scalars_by_step = table
            return {key: table[-1, i] for i, key in enumerate(self.keys)}

    def check_capturable(self) -> None:
        """Raise unless the group's collectives capture into a CUDA graph:
        NCCL's do, gloo's do not (no eager fallback)."""
        if self.group is not None and dist.get_backend(self.group) != "nccl":
            raise ValueError(f"steps_per_call={self.k} on CUDA captures the steps into one CUDA graph, and "
                             f"{dist.get_backend(self.group)}'s collectives do not capture: use the nccl backend "
                             "or steps_per_call=1")

    def _check_state(self, ts: TrainState) -> None:
        self.check_capturable()
        if self._ts is None:
            for opt in (ts.opt_g, ts.opt_d):
                for group in opt.param_groups if opt is not None else ():
                    if not (torch.is_tensor(group["lr"]) and group["capturable"]):
                        raise ValueError(f"steps_per_call={self.k} on CUDA needs capturable Adams with a tensor "
                                         "learning rate: build them with make_optimizers(model, steps_per_call)")
            self._ts = ts
        elif ts is not self._ts:
            raise ValueError("a MultiStep runs one train state: its CUDA graph holds that state's tensors")

    def _cuda_call(self, ts: TrainState, batches: Dict[str, torch.Tensor],
                   noises: List[Dict[str, Any]]) -> torch.Tensor:
        self._check_state(ts)
        device = batches["images"].device
        if self._static is None:
            self._static = ({key: torch.empty_like(v) for key, v in batches.items()},
                            [{key: torch.empty_like(torch.as_tensor(v, device=device)) for key, v in noise.items()}
                             for noise in noises],
                            torch.zeros((), dtype=torch.long, device=device))
        static_batches, static_noises, step = self._static
        shapes = {key: tuple(v.shape) for key, v in static_batches.items()}
        got = {key: tuple(v.shape) for key, v in batches.items()}
        if got != shapes:
            raise ValueError(f"a CUDA graph replays fixed shapes {shapes}, got {got}")
        with trace.span("multistep.copy_in"):
            for key, v in batches.items():
                static_batches[key].copy_(v)
            for slot, noise in zip(static_noises, noises):
                for key, v in noise.items():
                    if torch.is_tensor(v):
                        slot[key].copy_(v)
                    else:
                        slot[key].fill_(v)
            step.fill_(ts.step)
        if self.calls == 0:
            with trace.setup_span("multistep.eager"):
                return self._eager(ts, static_batches, static_noises, step)
        if self._graph is None:
            self._capture(ts, static_batches, static_noises, step)
        with trace.span("multistep.replay"):
            self._graph.replay()
            K.add_launches(self.graph_launches)
        trace.use_phases(self._phases)
        return self._out.clone()

    def _eager(self, ts, batches, noises, step) -> torch.Tensor:
        """The first call: the K steps, eagerly, on a side stream."""
        current = torch.cuda.current_stream(step.device)
        side = torch.cuda.Stream(step.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            table = self.steps(ts, batches, noises, step, trace.phases_for(step.device))
        current.wait_stream(side)
        table.record_stream(current)
        return table

    def dump_graph(self, path: str) -> None:
        """Write the captured graph's nodes (kernels by mangled name, copies,
        sets) to ``path`` as a DOT file (``cudaGraphDebugDotPrint``)."""
        if self._graph is None or not self.keep_graph:
            raise ValueError("dump_graph needs a graph captured with keep_graph set")
        self._graph.enable_debug_mode()  # debug_dump writes nothing without it
        self._graph.debug_dump(path)

    def _capture(self, ts, batches, noises, step) -> None:
        before = K.launch_dtypes()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        phases = trace.StepPhases()
        with trace.setup_span("multistep.capture") as span:
            # thread_local: the data feeder's thread goes on copying batches on its own stream
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self.steps(ts, batches, noises, step, phases)
            if self.keep_graph:
                graph.instantiate()  # capture_end instantiates only a graph it does not keep
        self.capture_s = span.seconds
        self._phases = phases
        self.graph_launches = _launch_delta(before, K.launch_dtypes())
        K.add_launches(self.graph_launches, -1)  # the capture launched nothing
        self._graph = graph


def make_eval_step(model, group: Optional[dist.ProcessGroup] = None, spatial: Optional[SpatialMesh] = None
                   ) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``eval_step(batch, zs_prior=None, generator=None) -> (gen_images,
    metrics)`` for ``model``: the prior rollout of ``forward(train=False)``
    and ``model.metrics_fn`` of it, under ``torch.inference_mode()``. The
    prior z is ``zs_prior`` when given, else drawn from ``generator`` (a
    ``torch.Generator`` on the batch's device). ``group``: the 0-d metrics
    are their means over its ranks (each on its own rows); ``gen_images``
    are this rank's. ``spatial``: ``batch`` holds this rank's rows of the
    height, ``gen_images`` are this rank's rows (the JAX spatial eval
    step's ``out_data="images"``), and the metrics, taken on gathered
    frames, are equal on the ranks of a spatial group."""

    def eval_step(batch: Dict[str, torch.Tensor], zs_prior: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with torch.inference_mode(), spatial_context(spatial):
            out = model(batch, train=False, zs_prior=zs_prior, generator=generator)
            metrics = model.metrics_fn(out, batch)
            if group is not None:
                all_reduce_mean_([v for v in metrics.values() if v.ndim == 0], group)
            return out["gen_images"], metrics

    return eval_step

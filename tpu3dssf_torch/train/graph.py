"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``.

The JAX package compiles its image encode, train step and eval step to one
program each (``jax.jit`` in ``tpu3dssf/train/loop.py``). The port runs the
same steps eagerly, one kernel launch from Python at a time, which leaves
the card waiting on the host. :func:`graphed` wraps a step so that on a
CUDA device each call replays one CUDA graph: one launch for the step.

A step is ``step(*args) -> outputs``, ``args`` and ``outputs`` pytrees
whose leaves are tensors or objects the step reads through (a model, a
train state). Per key of the arguments' tree structure, their tensors'
shapes, dtypes and devices, and their other leaves, by equality (a module
or a train state is equal only to itself), as JAX's jit caches a program
per shape and static argument:

1. the first call runs the eager step on a side stream. That call is the
   step: its result is returned, and an optimizer update it makes counts;
2. then the step is captured into a CUDA graph over static copies of the
   arguments. Capture executes nothing, so no parameter or optimizer state
   moves (there are no warm-up steps, which would update the weights). The
   graphs of a device share one memory pool, that of a live graph (a new
   one once none lives): they replay one at a time on one stream, their
   inputs live outside the pool and their outputs are cloned right after
   each replay;
3. every later call copies its arguments into the static copies, replays
   the graph and returns clones of its outputs: callers keep outputs across
   calls, and a replay overwrites the static ones.

With ``nodes=True`` each capture also keeps the CUDA graph's kernel nodes
(the graph's DOT dump, one label per node, function names included:
:meth:`_Graph.count_nodes`), so a caller can count the device kernels of
one replay where a profiler may lose records.

``before(*args)``, where given, runs on the host before every call and
returns the arguments the step takes (a train step draws its DropPath
masks there, which the graph then copies in as an input); ``after(*args)``
runs on the host after every call, on those arguments: the host halves
of a step, which a graph cannot replay (a train step's update count).

The kernels' launch counters (:data:`tpu3dssf_torch.kernels.modules.
COUNTERS`, kept by the ops' C++ kernels) are host integers, which a capture
raises though nothing runs then. The wrapper puts them back after a capture and adds the capture's
counts on every replay, so they go on counting the kernel launches made in
this process. :data:`CAPTURES` and :data:`REPLAYS` count the graphs
captured and replayed in this process, so a caller can tell that a path
ran through graphs.

A step may hold NCCL collectives (a data-parallel step over a mesh with
one rank per card, :mod:`tpu3dssf_torch.parallel`): the mesh makes every
communicator before any step runs (a lazy NCCL init cannot be captured),
the eager first call's collectives have finished before the capture
begins (``torch.cuda.graph`` synchronises the device), and the capture runs
in ``thread_local`` mode, so that the NCCL watchdog thread, which polls
the events of earlier collectives, does not invalidate it; each replay
runs the captured collectives, so every rank must replay its graph, as
every rank calls an eager step. Gloo collectives go through the host and
cannot be captured: a gloo mesh keeps its collectives outside any graph.

On CPU tensors the wrapper calls the eager step: there are no graphs. A
capture that fails raises; nothing falls back to the eager step. A restore
that replaces state a graph reads (``TrainState.load_state_dict``) drops the
graphs over that state with :func:`drop_graphs`; the next call captures
anew.
"""

from __future__ import annotations

import os
import re
import tempfile
import time
import warnings
import weakref
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from tpu3dssf_torch.kernels import modules as kernel_modules

# graphs captured and replayed in this process
CAPTURES = 0
REPLAYS = 0
_LIVE = weakref.WeakSet()   # every GraphedStep, for drop_graphs
_STREAMS: dict = {}         # device index -> the side stream


def _pool(device):
    """The memory pool of a live graph on ``device``, which the next
    capture shares, or None (a new pool) where no graph lives there. A pool
    is taken only from a live graph: once its last graph is gone, the
    allocator releases it."""
    for step in list(_LIVE):
        for g in step.graphs.values():
            if g.device == device:
                return g.graph.pool()
    return None


def _side_stream(device):
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    return _STREAMS[device.index]


def _capture_mode():
    """``thread_local`` where an NCCL process group is up (its watchdog
    thread polls events while a step is captured), else ``global``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return "thread_local"
    return "global"


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return x


class _Graph:
    """One captured step: the graph, its static inputs and outputs, the
    kernel launches it makes per replay and, where it was captured with
    ``nodes=True``, the labels of its nodes."""

    def __init__(self, graph, device, inputs, outputs, out_spec, launches,
                 nodes=None):
        self.graph, self.device = graph, device
        self.inputs, self.outputs, self.out_spec = inputs, outputs, out_spec
        self.launches, self.nodes = launches, nodes

    def count_nodes(self, pattern):
        """The nodes whose label matches ``pattern`` (a regular expression
        searched in each label; a kernel node's holds its function
        name)."""
        if self.nodes is None:
            raise ValueError("this graph was captured without nodes=True")
        return sum(1 for body in self.nodes if re.search(pattern, body))

    def replay(self, leaves):
        global REPLAYS
        for dst, src in zip(self.inputs, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.graph.replay()
        REPLAYS += 1
        counts = kernel_modules.launch_counts()
        kernel_modules.set_launch_counts(
            {k: counts[k] + n for k, n in self.launches.items() if n})
        return pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in self.outputs], self.out_spec)


class GraphedStep:
    """``step`` replayed as one CUDA graph per input key (see the module
    docstring); ``graphs`` maps each key to its capture."""

    def __init__(self, step: Callable, name: Optional[str] = None,
                 before: Optional[Callable] = None,
                 after: Optional[Callable] = None, nodes: bool = False):
        self.step, self.before, self.after = step, before, after
        self.nodes = nodes
        self.name = name or getattr(step, "__name__", "step")
        self.graphs: dict = {}
        _LIVE.add(self)

    def __call__(self, *args):
        if self.before is not None:
            args = self.before(*args)
        leaves, spec = pytree.tree_flatten(args)
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)), None)
        if device is None or device.type != "cuda":
            out = self.step(*args)
        else:
            key = (spec, tuple(map(_leaf_key, leaves)))
            graph = self.graphs.get(key)
            if graph is None:
                out = self._first_call(key, device, args, leaves, spec)
            else:
                out = graph.replay(leaves)
        if self.after is not None:
            self.after(*args)
        return out

    def _first_call(self, key, device, args, leaves, spec):
        """The eager step on the side stream, then its capture."""
        global CAPTURES
        with torch.cuda.device(device):
            stream = _side_stream(device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                out = self.step(*args)
            torch.cuda.current_stream().wait_stream(stream)

            t0 = time.perf_counter()
            inputs = [x.clone() if isinstance(x, torch.Tensor) else x
                      for x in leaves]
            graph = torch.cuda.CUDAGraph(keep_graph=self.nodes)
            if self.nodes:
                graph.enable_debug_mode()
            before = kernel_modules.launch_counts()
            try:
                with torch.cuda.graph(graph, pool=_pool(device),
                                      stream=stream,
                                      capture_error_mode=_capture_mode()):
                    captured = self.step(
                        *pytree.tree_unflatten(inputs, spec))
                counts = kernel_modules.launch_counts()
            finally:
                kernel_modules.set_launch_counts(before)
            nodes = None
            if self.nodes:
                nodes = _kernel_nodes(graph)
                graph.instantiate()
            outputs, out_spec = pytree.tree_flatten(captured)
            self.graphs[key] = _Graph(
                graph, device, inputs, outputs, out_spec,
                {k: counts[k] - before[k] for k in before}, nodes)
            CAPTURES += 1
        first = next((x for x in leaves if isinstance(x, torch.Tensor)),
                     None)
        print(f"[graph] {self.name}: captured CUDA graph "
              f"{len(self.graphs)} (first input {tuple(first.shape)}) in "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms; later calls of "
              "this shape replay it")
        return out

    def drop(self, obj):
        """Drop every graph captured over ``obj``."""
        self.graphs = {key: g for key, g in self.graphs.items()
                       if not any(x is obj for x in key[1])}


def _kernel_nodes(graph):
    """The labels of the nodes of a captured (not yet instantiated) graph,
    from its DOT dump: one statement a node, its label over several lines
    (a kernel node's holds the kernel's function name)."""
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")      # torch's "DEBUG: calling ..."
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    return re.findall(r'"\w+"\s*\[(.*?)\];', text, re.S)


def graphed(step: Callable, name: Optional[str] = None,
            before: Optional[Callable] = None,
            after: Optional[Callable] = None,
            nodes: bool = False) -> GraphedStep:
    """``step(*args)`` as a :class:`GraphedStep` (the module docstring says
    how it runs)."""
    return GraphedStep(step, name, before, after, nodes)


def drop_graphs(obj):
    """Drop every graph captured over ``obj`` (a restore replaced state
    those graphs read)."""
    for step in list(_LIVE):
        step.drop(obj)


def graph_train_step(train_step) -> GraphedStep:
    """The train step a loop runs: its device half (``train_step.update``)
    graphed, its host halves around every call: ``train_step.draw`` before
    (the DropPath masks of the update, an input of the graph) and
    ``train_step.advance`` after (the update count). Every configuration
    trains so: each update decision is device state
    (:mod:`tpu3dssf_torch.train.state`)."""
    return graphed(train_step.update, "train_step", before=train_step.draw,
                   after=train_step.advance)

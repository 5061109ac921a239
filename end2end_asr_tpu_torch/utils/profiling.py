"""The port's tracer (`RECORDER`), and ``--trace-dir``.

`RECORDER`, one a process, always on, holds:

* host spans (`Recorder.span`): name, start and end on `time.perf_counter`
  (the clock the benchmark's own spans use), the enclosing span and the
  dispatch number, in a bounded ring whose oldest spans are dropped. A span opened inside a span of the same name is the outer one
  (the trainer's ``dispatch`` around GraphedSteps' own);
* device stamps (`Recorder.stamp`): on a CUDA device a one-thread kernel
  (csrc/trace.cu) writes (stamp id, %globaltimer) into a ring in device
  memory, on the caller's stream, so that a stamp captured into a CUDA
  graph appends its entry at every replay. The ring is copied out only
  when asked (`collect`: `summary`, GraphedSteps.close, the trainer's
  epoch end), never inside the dispatch loop. Device time maps to the host
  clock through anchors: one stamp between a synchronize and two
  perf_counter reads, at the ring's first use and at each copy-out; the
  stamps between two anchors are placed by the line through them, and
  the last copy-out's disagreement with the anchor before it is the
  counter ``stamp_clock_drift_us``. Entries overwritten on the card before
  a copy-out leave a ``lost`` mark in their place, so that no interval
  spans them. On the CPU a stamp is a perf_counter mark (CPU work is
  synchronous). A stamp under a CUDA graph's capture on a card whose ring
  does not exist yet raises: the ring is made and anchored outside any
  capture (GraphedSteps stamps each call's start before it captures);
* named counters, and each CUDA graph's counters keyed by (owner, shape):
  its launches, hand-offs, pool growth and replays (GraphedSteps), and the
  kernel, memcpy, memset and other nodes each part added to it at capture
  (`counting`), the stamps left out;
* profiler ranges at named sites of the program (`range`), off unless a
  tool turns one on (`ranges_on`; tools/probe_step.py).

The interval between two consecutive stamps of one device belongs to the
part `part_of` names: the step's ``forward`` (its start, or the last
microbatch's backward, to after the loss), ``backward`` (to after the
gradients' concatenation), ``update`` (the reductions over ranks, the
clip, the optimizer and the finite picks), ``writeback`` (a CUDA graph's
copy of the new state into its static buffers), ``stage`` (a dispatch's
start to its first step), ``outputs`` (its last step to its end),
``gap`` (one dispatch's end to the next one's start: the card idle
between calls, or busy with work outside any dispatch) and ``between``.
`summary(lo, hi)` gives the totals of spans and parts inside a host-clock
window, and the spans and stamps lost (dropped from the full host lists,
or overwritten on the card) that may fall inside it; `card_window(lo, hi)`
is that summary where the card stamped inside the window and nothing of
it was lost, the benchmark's readers' source.

``--trace-dir`` (`trace`): a torch.profiler trace of a block of the run (the
JAX package's ``utils/profiling.trace``, which takes a jax.profiler trace of
the first training epoch), in which the tracer's spans are ranges too. The
trace is one ``<host>_<pid>.<ms>.pt.trace.json`` file in the given
directory, in the Chrome trace format that TensorBoard's profiler plugin
and chrome://tracing read: host operators, and on a card its kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import math
import os
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import torch

from end2end_asr_tpu_torch.ops import cuda_lib

SPAN_CAPACITY = 1 << 16     # host spans kept
# device ring entries: a 51 s window at ~6 stamps a 12 ms step is ~25 k
STAMP_CAPACITY = 1 << 17
HOST_STAMPS = 1 << 18       # stamps copied out, and the CPU's marks

# stamp names
STEP_START = "step.start"
FORWARD, BACKWARD, UPDATE, WRITEBACK = ("forward", "backward", "update",
                                        "writeback")
DISPATCH_START, DISPATCH_END = "dispatch.start", "dispatch.end"
ANCHOR = "anchor"           # id 0: the clocks' anchors, not a part
LOST = "lost"               # in place of stamps lost on the card

STAMP = cuda_lib.CudaKernel(
    "trace", "trace_stamp", [cuda_lib.P, cuda_lib.P, cuda_lib.U64,
                             cuda_lib.U64, cuda_lib.P])
CAPTURE_NODES = cuda_lib.CudaKernel("trace", "trace_capture_nodes",
                                    [cuda_lib.P, cuda_lib.P])
GRAPH_NODES = cuda_lib.CudaKernel("trace", "trace_graph_nodes",
                                  [cuda_lib.P, cuda_lib.P])
NODE_KINDS = ("kernel", "memcpy", "memset", "other")


def part_of(prev: Optional[str], cur: str) -> str:
    """The part of the interval from stamp `prev` to stamp `cur`."""
    if cur == STEP_START:
        return "stage" if prev == DISPATCH_START else "between"
    if cur == DISPATCH_START:
        return "gap" if prev == DISPATCH_END else "between"
    if cur == DISPATCH_END:
        return "outputs"
    return cur


def _nodes(query: cuda_lib.CudaKernel, handle: int) -> List[int]:
    """[kernel, memcpy, memset, other] nodes by a query of csrc/trace.cu
    (called through the library, not `launch`: a query is no launch)."""
    out = (ctypes.c_long * 4)()
    err = query.load()(handle, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{query.symbol}: CUDA error {err} "
                           f"({query._lib.error_string(err).decode()})")
    return list(out)


def graph_nodes(graph: int) -> Dict[str, int]:
    """{kind: nodes} of a finished cudaGraph_t (CUDAGraph.raw_cuda_graph of
    a graph made with keep_graph=True)."""
    return dict(zip(NODE_KINDS, _nodes(GRAPH_NODES, graph)))


def _capture_nodes(stream) -> List[int]:
    return _nodes(CAPTURE_NODES, stream.cuda_stream)


class _Span:
    __slots__ = ("rec", "name", "nested", "id", "parent", "dispatch", "t0",
                 "range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.nested = top is not None and top.name == self.name
        if self.nested:
            return self
        self.parent = top.id if top is not None else 0
        self.id = next(rec._ids)
        if self.name == "dispatch":
            rec.dispatch += 1
        self.dispatch = rec.dispatch
        stack.append(self)
        self.range = None
        if rec.profiler_ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.nested:
            return False
        t1 = time.perf_counter()
        rec = self.rec
        if self.range is not None:
            self.range.__exit__(*exc)
        rec._stack().pop()
        if len(rec.spans) == rec.spans.maxlen:
            rec._lose("spans", rec.spans[0][3])
        rec.spans.append((self.id, self.name, self.t0, t1, self.parent,
                          self.dispatch))
        return False


class _Ring:
    """The stamps' ring of one CUDA device: (index << 16 | id, ns) rows."""

    def __init__(self, rec: "Recorder", device: torch.device):
        self.rec, self.device = rec, device
        self.capacity = rec.stamp_capacity
        self.ring = torch.zeros(self.capacity, 2, dtype=torch.int64,
                                device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.read = 0
        self.anchor = self._anchor()

    def launch(self, sid: int, stream) -> None:
        STAMP.launch(self.ring.data_ptr(), self.cursor.data_ptr(),
                     self.capacity - 1, sid, stream.cuda_stream)

    def _anchor(self) -> Tuple[int, float]:
        """(device ns, host s) of one stamp on an idle card; its entry is
        taken as read."""
        torch.cuda.synchronize(self.device)
        h0 = time.perf_counter()
        self.launch(0, torch.cuda.current_stream(self.device))
        torch.cuda.synchronize(self.device)
        h1 = time.perf_counter()
        self.read = int(self.cursor.item())
        ns = int(self.ring[(self.read - 1) % self.capacity, 1].item())
        return ns, 0.5 * (h0 + h1)

    def collect(self) -> None:
        torch.cuda.synchronize(self.device)
        end = int(self.cursor.item())
        if end == self.read:
            return
        rec = self.rec
        lo = max(self.read, end - self.capacity)
        lost = lo - self.read           # overwritten before this copy-out
        idx = torch.arange(lo, end, dtype=torch.int64)
        rows = self.ring.cpu()[idx % self.capacity].tolist()
        (g0, h0), (g1, h1) = self.anchor, self._anchor()
        rate = (h1 - h0) / (g1 - g0)
        rec.counters["stamp_clock_drift_us"] = (
            h0 + (g1 - g0) * 1e-9 - h1) * 1e6
        key = self.device.index
        for i, (word, ns) in zip(idx.tolist(), rows):
            if word >> 16 != i:
                lost += 1
                continue
            t = h0 + (ns - g0) * rate
            if lost:
                rec._break(key, t, lost)
                lost = 0
            if word & 0xFFFF:
                rec._keep(rec.names[word & 0xFFFF], t, key)
        if lost:
            rec._break(key, h1, lost)
        self.anchor = (g1, h1)


class Recorder:
    """Host spans, device stamps and counters of one process (see the
    module's docstring)."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY,
                 stamp_capacity: int = STAMP_CAPACITY,
                 host_stamps: int = HOST_STAMPS):
        self.stamp_capacity = stamp_capacity
        # (id, name, start, end, parent id, dispatch)
        self.spans: deque = deque(maxlen=span_capacity)
        # (name, host s, device index or "cpu")
        self.stamps: deque = deque(maxlen=host_stamps)
        self.counters: Counter = Counter()
        # {"spans" | "stamps": [lost, the newest lost one's host s]}
        self.lost: Dict[str, list] = {}
        self.graphs: Dict[tuple, dict] = {}
        self.dispatch = 0
        self.profiler_ranges = False
        self.ranges: Dict[str, str] = {}
        self.names: List[str] = [ANCHOR]
        self._sid: Dict[str, int] = {ANCHOR: 0}
        self._rings: Dict[int, _Ring] = {}
        self._capture: Optional[dict] = None
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._owners = itertools.count(1)

    def clear(self) -> None:
        """Forget every span, stamp, counter and graph (the rings stay)."""
        for ring in self._rings.values():
            ring.collect()
        self.spans.clear()
        self.stamps.clear()
        self.counters.clear()
        self.lost.clear()
        self.graphs.clear()
        self.dispatch = 0

    # -- host spans --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str) -> _Span:
        """A context manager: the block as a host span `name`."""
        return _Span(self, name)

    # -- losses ------------------------------------------------------------
    def _lose(self, kind: str, t: float, n: int = 1) -> None:
        """`n` entries of `kind` lost, the newest at (or before) host time
        `t`. The lists lose their oldest entries first, so that whatever
        was lost lies before the newest loss."""
        got = self.lost.setdefault(kind, [0, -math.inf])
        got[0] += n
        got[1] = max(got[1], t)

    def _break(self, key, t: float, n: int) -> None:
        """`n` stamps of device `key` overwritten before host time `t`."""
        self._lose("stamps", t, n)
        self._keep(LOST, t, key)

    # -- stamps ------------------------------------------------------------
    def _keep(self, name: str, t: float, key) -> None:
        if len(self.stamps) == self.stamps.maxlen:
            self._lose("stamps", self.stamps[0][1])
        self.stamps.append((name, t, key))

    def stamp(self, name: str, device: torch.device) -> None:
        """Stamp `name` on `device`'s current stream (on the CPU: now)."""
        if device.type != "cuda":
            self._keep(name, time.perf_counter(), "cpu")
            return
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        ring = self._rings.get(index)
        capturing = torch.cuda.is_current_stream_capturing()
        if ring is None:
            if capturing:       # making the ring synchronizes the card
                raise RuntimeError(
                    f"stamp {name!r} under a CUDA graph capture before "
                    f"cuda:{index}'s stamp ring exists: stamp once outside "
                    f"the capture first")
            ring = self._rings[index] = _Ring(self, torch.device("cuda",
                                                                 index))
        sid = self._sid.get(name)
        if sid is None:
            sid = self._sid[name] = len(self.names)
            self.names.append(name)
        stream = torch.cuda.current_stream(index)
        if capturing and self._capture is not None:
            self._count(name, stream)
        ring.launch(sid, stream)

    def collect(self) -> None:
        """Copy the new entries of every device ring out (synchronizes)."""
        for ring in self._rings.values():
            ring.collect()

    # -- graph counters ----------------------------------------------------
    def owner(self, kind: str) -> str:
        """A new owner's name for `graph` keys."""
        return f"{kind}.{next(self._owners)}"

    def graph(self, owner: str, key) -> dict:
        """The counters of `owner`'s graph of shape `key` (made empty)."""
        return self.graphs.setdefault((owner, key), {})

    def graphs_of(self, owner: str) -> Dict[tuple, dict]:
        return {k: v for (o, k), v in self.graphs.items() if o == owner}

    def _count(self, name: str, stream) -> None:
        cap = self._capture
        now = _capture_nodes(stream)
        part = part_of(cap["prev"], name) if cap["prev"] else "stage"
        got = cap["parts"].setdefault(part, [0, 0, 0, 0])
        for k in range(4):
            got[k] += now[k] - cap["last"][k]
        now[0] += 1                             # the stamp's own node
        cap["last"], cap["prev"] = now, name
        cap["stamps"] += 1

    @contextlib.contextmanager
    def counting(self, owner: str, key, steps: int):
        """Inside a CUDA graph's capture of `steps` steps: each part's
        kernel, memcpy, memset and other nodes a step (the nodes after the
        last stamp are ``outputs``), into graph(owner, key)["nodes"], and
        the graph's kernel nodes without the stamps into
        ["kernel_nodes"]."""
        stream = torch.cuda.current_stream()
        self._capture = {"prev": None, "last": _capture_nodes(stream),
                         "parts": {}, "stamps": 0}
        try:
            yield
            self._count(DISPATCH_END, stream)
            cap = self._capture
            total = [sum(p[k] for p in cap["parts"].values())
                     for k in range(4)]
            self.graph(owner, key).update(
                steps=steps, stamps=cap["stamps"] - 1,
                kernel_nodes=total[0],
                nodes={part: {kind: n / steps for kind, n in zip(NODE_KINDS,
                                                                 p)}
                       for part, p in cap["parts"].items()})
        finally:
            self._capture = None

    # -- profiler ranges at the program's sites ----------------------------
    def range(self, site: str):
        """A torch.profiler range around the block where `ranges_on` has
        named one for `site`; nothing otherwise."""
        name = self.ranges.get(site)
        return (torch.profiler.record_function(name) if name
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def ranges_on(self, **names: str):
        """Name the profiler ranges of the given sites inside the block."""
        old = dict(self.ranges)
        self.ranges.update(names)
        try:
            yield
        finally:
            self.ranges = old

    # -- reading -----------------------------------------------------------
    def intervals(self, lo: float = -math.inf, hi: float = math.inf):
        """[(part, start, end, device)] between consecutive stamps of one
        device ("cpu" for the CPU's marks), host clock, both ends inside
        [lo, hi], none across a `LOST` mark; copies the device rings out
        first."""
        self.collect()
        last: Dict[object, tuple] = {}
        out = []
        for name, t, key in self.stamps:
            prev = last.get(key)
            last[key] = (name, t)
            if (prev is not None and LOST not in (prev[0], name)
                    and prev[1] >= lo and t <= hi):
                out.append((part_of(prev[0], name), prev[1], t, key))
        return out

    def summary(self, lo: float = -math.inf, hi: float = math.inf) -> dict:
        """Totals inside the host-clock window [lo, hi]: "spans" and
        "parts" {name: {"n", "s"}} (spans and stamp intervals wholly
        inside), "device_stamps" (the card's stamps inside), "lost"
        {"spans", "stamps"}: 0 where nothing lost can lie inside the
        window (the newest loss came before `lo`), else the process's
        count of such losses, "counters", "graphs" {(owner, key):
        counters}."""
        parts: Dict[str, dict] = {}
        for part, a, b, _ in self.intervals(lo, hi):
            p = parts.setdefault(part, {"n": 0, "s": 0.0})
            p["n"] += 1
            p["s"] += b - a
        spans: Dict[str, dict] = {}
        for _, name, a, b, _, _ in self.spans:
            if a >= lo and b <= hi:
                s = spans.setdefault(name, {"n": 0, "s": 0.0})
                s["n"] += 1
                s["s"] += b - a
        lost = {kind: 0 for kind in ("spans", "stamps")}
        for kind, (n, t) in self.lost.items():
            lost[kind] = n if t >= lo else 0
        return {"spans": spans, "parts": parts,
                "device_stamps": sum(1 for name, t, key in self.stamps
                                     if key != "cpu" and name != LOST
                                     and lo <= t <= hi),
                "lost": lost, "counters": dict(self.counters),
                "graphs": {k: dict(v) for k, v in self.graphs.items()}}

    def card_window(self, lo: float, hi: float) -> Optional[dict]:
        """`summary(lo, hi)` where the card stamped inside the window and
        nothing that may lie inside it was lost; None otherwise (a CPU
        run, or a loss)."""
        s = self.summary(lo, hi)
        return s if s["device_stamps"] and not any(s["lost"].values()) \
            else None


RECORDER = Recorder()


def per_step(summary: dict, steps: int) -> str:
    """One line of a `Recorder.summary`: the ms a step of each host span
    and of each part of the steps, on the card's clock where the card
    stamped them, else on the host's (the CPU's marks); then the spans and
    stamps lost that may lie in the summary's window (the parts are short
    by them) and the clocks' drift at the last copy-out."""
    steps = max(steps, 1)
    ms = lambda d: " ".join(f"{n} {1e3 * v['s'] / steps:.3f}"
                            for n, v in sorted(d.items()))
    clock = "device" if summary["device_stamps"] else "host"
    lost = summary["lost"]
    drift = summary["counters"].get("stamp_clock_drift_us", 0.0)
    return (f"host ms a step: {ms(summary['spans'])}; {clock} ms a step: "
            f"{ms(summary['parts'])}; lost spans {lost['spans']} stamps "
            f"{lost['stamps']}; clock drift {drift:.1f} us")


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: torch.device):
    """Profile the block into `log_dir` when it is set, the tracer's spans
    as ranges in it; a no-op otherwise. On a CUDA device the card's
    kernels are traced too, and the block's work is waited for before the
    trace is written."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        RECORDER.profiler_ranges = True
        try:
            yield
        finally:
            RECORDER.profiler_ranges = False
            if device.type == "cuda":
                torch.cuda.synchronize(device)

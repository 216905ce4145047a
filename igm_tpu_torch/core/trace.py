"""The port's tracing registry: spans and counters, always on.

One registry a process, read by the benchmark's per-layer metrics, the
trainer's ``trace/*`` scalars, the sampler service's ``/stats`` and the
profiling tools:

- :func:`span` times a region on ``time.perf_counter_ns``: its name, its
  thread, start and end, the enclosing span on the same thread (its
  parent) and the thread's request id (:func:`request`).  A name keeps its
  count, total time and self time (the time outside its child spans), and
  each thread keeps its last :data:`RING` records in a ring of its own, for
  the quantiles and the timeline.  The hot path takes no lock, makes no
  ``record_function`` (6.5-7.5 us a call even with no profiler running)
  and no host sync: a span costs about a microsecond of the host's time.
  A thread that has ended leaves its ring and totals to the next thread
  that starts timing (a prefetcher's worker an epoch, an HTTP handler a
  request), so the rings stay as many as the threads alive at once;
- :func:`count` adds to a host counter; ``work=True`` marks one that counts
  device work (collective calls and bytes), which
  ``core/graphs.py`` ``StepGraph`` takes back from a capture and adds again
  at every replay, as it does the kernel wrappers' ``launches``;
- :func:`device_counter` is a device tensor the registry owns, which code
  inside a graph adds to in place (a replay adds again by itself).  It is
  no module's buffer: state dicts and checkpoints do not see it, and it
  outlives the module;
- :func:`snapshot` reads it all (the device counters with one sync a
  device); :func:`on_timeline` places the records that fall inside a
  finished ``torch.profiler`` run on that run's timeline, from every
  thread, beside the kernels (``torch.profiler`` itself records ranges on
  the thread that started it alone).

Names are ``<layer>.<what>``, the layers of the port's ``PERF.md``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

#: records a thread keeps (a power of two)
RING = 4096
_MASK = RING - 1

_now = time.perf_counter_ns
_local = threading.local()
_lock = threading.Lock()
_states: List["_Thread"] = []
_free: List["_Thread"] = []             # the states of threads that have ended
_thread_names: Dict[int, str] = {}
_counters: Dict[str, float] = {}
_work: set = set()
_device: Dict[tuple, Any] = {}
_request_ids = itertools.count(1)


class _Thread:
    """A thread's spans: the open ones, the totals of each name (``[count,
    total ns, self ns]``) and the ring of records.  A record is the list
    ``[name, parent, start ns, request, thread id, end ns]``; while the
    span is open its second entry holds its children's time."""
    __slots__ = ("tid", "stack", "totals", "ring", "pos", "request")

    def __init__(self):
        self.totals: Dict[str, list] = {}
        self.ring: list = [None] * RING
        self.pos = 0


class _Owner:
    """Kept in a thread's local storage, which the thread's end clears: its
    state then goes back for the next thread to take."""
    __slots__ = ("state",)

    def __init__(self, state: _Thread):
        self.state = state

    def __del__(self):
        _free.append(self.state)


def _register() -> _Thread:
    """This thread's state: a finished thread's, or a new one."""
    try:
        state = _free.pop()
    except IndexError:
        state = _Thread()
        with _lock:
            _states.append(state)
    state.tid = threading.get_native_id()
    state.stack, state.request = [], None
    _thread_names[state.tid] = threading.current_thread().name
    _local.state = state
    _local.owner = _Owner(state)
    return state


def _state() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        return _register()


class _Span:
    """The context manager of one name; what is open lives on the thread's
    stack, so one object serves every thread and every nesting."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            state = _local.state
        except AttributeError:
            state = _register()
        state.stack.append([self.name, 0, _now(), state.request, state.tid])

    def __exit__(self, exc_type, exc, tb):
        end = _now()
        state = _local.state
        stack = state.stack
        record = stack.pop()
        took = end - record[2]
        own = took - record[1]
        if stack:
            parent = stack[-1]
            parent[1] += took
            record[1] = parent[0]
        else:
            record[1] = None
        record.append(end)
        try:
            total = state.totals[record[0]]
        except KeyError:
            total = state.totals[record[0]] = [0, 0, 0]
        total[0] += 1
        total[1] += took
        total[2] += own
        pos = state.pos
        state.ring[pos & _MASK] = record
        state.pos = pos + 1


class _SpanTable(dict):
    def __missing__(self, name: str) -> _Span:
        return self.setdefault(name, _Span(name))


_spans = _SpanTable()
#: ``with span("loader.stage"): ...`` times the block under that name
span = _spans.__getitem__


@contextlib.contextmanager
def request(rid: Optional[int] = None) -> Iterator[int]:
    """The spans this thread opens inside the block carry request id
    ``rid`` (a new one when None), which the block receives."""
    state = _state()
    saved = state.request
    state.request = next(_request_ids) if rid is None else rid
    try:
        yield state.request
    finally:
        state.request = saved


def count(name: str, n: float = 1, work: bool = False) -> None:
    """Add ``n`` to the host counter ``name``; ``work``: it counts device
    work, which a replayed graph makes again (``StepGraph``)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if work:
            _work.add(name)


def work_counts() -> Dict[str, float]:
    """The counters of device work, as they stand."""
    with _lock:
        return {k: _counters[k] for k in _work}


def device_counter(name: str, size: int, device) -> "torch.Tensor":
    """The registry's float64 counter ``name`` of ``size`` entries on
    ``device`` (zeros when new), to add to in place.  Its first use must
    come before a graph's capture (a ``StepGraph``'s eager first call)."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(device))
    counter = _device.get(key)
    if counter is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} first used inside a capture")
        counter = _device[key] = torch.zeros(size, dtype=torch.float64, device=device)
    return counter


def _kept() -> List[list]:
    """Every thread's kept records, oldest first within a thread."""
    out: List[list] = []
    for state in list(_states):
        pos = state.pos
        ring = state.ring
        if pos <= RING:
            out.extend(ring[:pos])
        else:
            start = pos & _MASK
            out.extend(ring[start:] + ring[:start])
    return [r for r in out if r is not None]


def records() -> List[dict]:
    """The kept records of every thread: ``name``, ``start_ns``, ``end_ns``
    (``perf_counter_ns``), ``parent``, ``request``, ``thread`` (the native
    id)."""
    return [{"name": name, "start_ns": start, "end_ns": end, "parent": parent,
             "request": rid, "thread": tid}
            for name, parent, start, rid, tid, end in _kept()]


def spans() -> Dict[str, dict]:
    """Each span name's ``count``, ``total_s``, ``self_s`` over the
    process's life, and ``p50_s``, ``p95_s`` over the kept records (None
    where none is kept)."""
    totals: Dict[str, list] = {}
    for state in list(_states):
        for name, (n, total, own) in list(state.totals.items()):
            t = totals.setdefault(name, [0, 0, 0])
            t[0] += n
            t[1] += total
            t[2] += own
    took: Dict[str, list] = {}
    for name, _, start, _, _, end in _kept():
        took.setdefault(name, []).append(end - start)
    out = {}
    for name, (n, total, own) in totals.items():
        p50 = p95 = None
        if name in took:
            p50, p95 = (1e-9 * float(v) for v in np.percentile(took[name], (50, 95)))
        out[name] = {"count": n, "total_s": total * 1e-9, "self_s": own * 1e-9,
                     "p50_s": p50, "p95_s": p95}
    return out


def counters() -> Dict[str, Any]:
    """The host counters, and the device counters as lists (summed over
    the devices a name is on), read with one sync a device."""
    import torch
    with _lock:
        out: Dict[str, Any] = dict(_counters)
        device = dict(_device)
    by_device: Dict[str, list] = {}
    for (name, dev), t in device.items():
        by_device.setdefault(dev, []).append((name, t))
    for items in by_device.values():
        values = torch.cat([t for _, t in items]).tolist()
        offset = 0
        for name, t in items:
            part = values[offset:offset + t.numel()]
            offset += t.numel()
            have = out.get(name)
            out[name] = part if have is None else [a + b for a, b in zip(have, part)]
    return out


def snapshot() -> dict:
    """``{"spans": spans(), "counters": counters()}``."""
    return {"spans": spans(), "counters": counters()}


def _wall_minus_perf() -> int:
    """The wall clock less ``perf_counter_ns``, from the closest of a few
    reads."""
    best = None
    for _ in range(5):
        a = time.time_ns()
        p = _now()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - p)
    return best[1]


def on_timeline(prof) -> List[dict]:
    """:func:`records` that overlap a finished ``torch.profiler`` run, on its
    timeline (``start_us``, ``end_us``: microseconds from its start, as its
    events' ``time_range``), with each thread's name, sorted by start."""
    origin = prof.profiler.kineto_results.trace_start_ns() - _wall_minus_perf()
    end_us = max((e.time_range.end for e in prof.events()), default=0.0)
    out = []
    for r in records():
        r["start_us"] = (r.pop("start_ns") - origin) / 1e3
        r["end_us"] = (r.pop("end_ns") - origin) / 1e3
        if r["end_us"] >= 0 and r["start_us"] <= end_us:
            r["thread_name"] = _thread_names.get(r["thread"], str(r["thread"]))
            out.append(r)
    out.sort(key=lambda r: r["start_us"])
    return out


def export_chrome_trace(prof, path: str) -> None:
    """``prof.export_chrome_trace(path)``, with :func:`on_timeline`'s
    records added: each thread's spans on a track of their own beside that
    thread's, named ``spans: <thread name>``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    origin_us = (prof.profiler.kineto_results.trace_start_ns()
                 - int(trace.get("baseTimeNanoseconds", 0))) / 1e3
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    named = set()
    for r in on_timeline(prof):
        tid = (1 << 32) + r["thread"]
        if tid not in named:
            named.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": f"spans: {r['thread_name']}"}})
        events.append({"ph": "X", "cat": "igm_trace", "name": r["name"], "pid": pid,
                       "tid": tid, "ts": origin_us + r["start_us"],
                       "dur": r["end_us"] - r["start_us"],
                       "args": {"parent": r["parent"], "request": r["request"]}})
    with open(path, "w") as f:
        json.dump(trace, f)

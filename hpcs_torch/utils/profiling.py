"""Tracing, step timing and NaN debugging: the counterpart of
hpcs_tpu/utils/profiling.py.

- `trace(log_dir)`: a torch.profiler trace of the block (CPU, and CUDA on
  a machine with a GPU), written as one Chrome / Perfetto trace
  `<host>_<pid>.<ns>.pt.trace.json` under log_dir, which TensorBoard's
  profile plugin and Perfetto read.  While it is active every nn.Module
  call opens a span named by the module's state_dict path under the
  outermost module called (`nn_feat.conv6`, `nn_emb`; the outermost one by
  its class, `HypHCNet`), and `span(name)` opens one: the system's steps
  (`train_step`, `eval_step`, `test_step`, `embed`, `decode`), the
  optimizer's `optimizer.step` and the kernels' wrappers (`knn`,
  `edgeconv`).  The module hooks are registered when the first trace or
  NaN check starts and removed when the last one ends, so that they cost
  nothing outside them.
- `barrier(tree)`: waits for the devices of a tree's CUDA tensors.
- `StepTimer`: per-step wall time with a barrier, the JAX package's
  summary keys.
- `enable_nan_debugging()` / `disable_nan_debugging()`, or the context
  `nan_debugging()`: raise FloatingPointError at the first operation whose
  floating output holds a NaN, naming the operation and where it ran: the
  innermost module path and the spans opened inside it (jax_debug_nans'
  counterpart).  The forward is checked by a TorchDispatchMode over every
  aten operation, the backward by autograd's anomaly mode.  The kernels,
  bound through ctypes, are invisible to the dispatcher: their wrappers
  check their own results (`check_kernel`), on the kernels themselves.
- `check_finite(tree, name)`: a host-side check over nested dicts, lists
  and tensors (a state_dict), raising with the offending path in the JAX
  package's form (`name['b']['c']`).
"""
import contextlib
import functools
import inspect
import os
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# outputs that hold no computed value (uninitialised memory); views are not
# checked either: they show values checked when they were made
_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                        "resize_", "set_", "record_stream"})


class _Tracker:
    """The process's stack of open modules and spans, and the module hooks
    that keep it while a trace or the NaN checks are on."""

    def __init__(self):
        self.traces = 0  # active traces: spans open profiler ranges
        self.nan_checks = 0  # active NaN debugging: kernels check their outputs
        self.suspended = 0  # checks' own operations are not checked
        self.stack = []  # (name, is_module, record_function or None)
        self.names = weakref.WeakKeyDictionary()
        self.root = None  # a weak reference to the outermost module last named
        self.handles = ()

    @property
    def on(self):
        return bool(self.traces or self.nan_checks)

    def push(self, name, is_module):
        rf = None
        if self.traces:
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
        self.stack.append((name, is_module, rf))

    def pop(self, count=1):
        for _ in range(min(count, len(self.stack))):
            _, _, rf = self.stack.pop()
            if rf is not None:
                rf.__exit__(None, None, None)

    def module_path(self):
        return next((name for name, is_module, _ in reversed(self.stack) if is_module), None)

    def where(self):
        """The innermost module path, then the spans opened inside it."""
        parts = []
        for name, is_module, _ in reversed(self.stack):
            parts.append(name)
            if is_module:
                break
        return "/".join(reversed(parts)) or "outside any module"

    def enter_module(self, module, args):
        name = self.names.get(module)
        parent = self.module_path()
        if parent is None and (self.root is None or self.root() is not module):
            # the outermost module called: its tree is named by state_dict paths
            self.root = weakref.ref(module)
            for path, m in module.named_modules():
                self.names[m] = path
            name = ""
        elif name is None:
            name = f"{parent}.<{type(module).__name__}>"
        self.push(name or type(module).__name__, True)

    def exit_module(self, module, args, output):
        for depth, (_, is_module, _) in enumerate(reversed(self.stack)):
            if is_module:
                self.pop(depth + 1)
                return

    def acquire(self, kind):
        if not self.on:
            from torch.nn.modules import module as M

            try:
                post = M.register_module_forward_hook(self.exit_module, always_call=True)
            except TypeError:  # a PyTorch without always_call
                post = M.register_module_forward_hook(self.exit_module)
            self.handles = (M.register_module_forward_pre_hook(self.enter_module), post)
        setattr(self, kind, getattr(self, kind) + 1)

    def release(self, kind):
        setattr(self, kind, getattr(self, kind) - 1)
        if not self.on:
            for handle in self.handles:
                handle.remove()
            self.handles = ()
            self.pop(len(self.stack))
            self.names = weakref.WeakKeyDictionary()
            self.root = None


_TRACKER = _Tracker()


class _Span:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _TRACKER.push(self.name, False)
        self.depth = len(_TRACKER.stack)
        return self

    def __exit__(self, *exc):
        _TRACKER.pop(len(_TRACKER.stack) - self.depth + 1)
        return False


def span(name):
    """A named span around a block: a profiler range under `trace`, and a
    place that the NaN checks name.  Nothing outside them."""
    return _Span(name) if _TRACKER.on else contextlib.nullcontext()


def spanned(name):
    """Decorate a function so that each call is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def open_spans():
    """The names on the stack of open modules and spans, outermost first."""
    return [name for name, _, _ in _TRACKER.stack]


@contextlib.contextmanager
def trace(log_dir):
    """Profiler trace of the block; writes `<host>_<pid>.<ns>.pt.trace.json`
    under log_dir, with a span for each module call and each `span`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = {"acc_events": True} if "acc_events" in inspect.signature(profile).parameters else {}
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                   **kwargs)
    _TRACKER.acquire("traces")
    depth = len(_TRACKER.stack)
    try:
        prof.start()
        try:
            yield prof
        finally:
            _TRACKER.pop(len(_TRACKER.stack) - depth)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
    finally:
        _TRACKER.release("traces")


def trace_files(log_dir):
    """The trace files under log_dir, oldest first."""
    found = [os.path.join(root, f) for root, _, files in os.walk(log_dir) for f in files
             if f.endswith(".pt.trace.json") or f.endswith(".pt.trace.json.gz")]
    return sorted(found, key=os.path.getmtime)


def barrier(tree):
    """Wait for the devices of every CUDA tensor in `tree`; returns tree."""
    devices = {t.device for t in tree_leaves(tree) if torch.is_tensor(t) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


class StepTimer:
    """Rolling per-step timing: `with timer.step(result): ...` then
    timer.summary().  The first `warmup` steps are not kept."""

    def __init__(self, warmup=1):
        self.warmup = warmup
        self.times = []
        self._count = 0

    @contextlib.contextmanager
    def step(self, result_tree=None):
        t0 = time.perf_counter()
        yield
        if result_tree is not None:
            barrier(result_tree)
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_timed": len(arr),
        }


def _nan_message(what, t):
    n = int(torch.isnan(t).sum())
    node = getattr(torch._C, "_current_autograd_node", lambda: None)()
    where = f"the backward ({node.name()})" if node is not None else _TRACKER.where()
    return (f"invalid value (nan) encountered in {what} at {where}: {n} NaN of "
            f"{t.numel()} in its output {t.dtype} {tuple(t.shape)}")


class _NaNMode(TorchDispatchMode):
    """Checks each floating output of every aten operation for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (_TRACKER.suspended or getattr(func, "is_view", False)
                or func.overloadpacket.__name__ in _UNCHECKED):
            return out
        for t in tree_leaves(out):
            if (torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()) and t.numel()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(_nan_message(f"aten.{func.overloadpacket.__name__}", t))
        return out


_NAN_STATE = []  # (mode, anomaly mode before) of each enable_nan_debugging


def nan_debugging_enabled():
    return bool(_NAN_STATE)


def enable_nan_debugging():
    """Raise FloatingPointError at the first operation that makes a NaN:
    the forward's aten operations (a dispatch mode, this thread), the
    backward (autograd's anomaly mode, process-wide) and the kernels (their
    wrappers).  Undo with disable_nan_debugging."""
    anomaly = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    _TRACKER.acquire("nan_checks")
    mode = _NaNMode()
    mode.__enter__()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    _NAN_STATE.append((mode, anomaly))


def disable_nan_debugging():
    """Undo the last enable_nan_debugging: its dispatch mode, anomaly mode
    as it was before, and the module hooks when nothing else needs them."""
    mode, (anomaly, check_nan) = _NAN_STATE.pop()
    try:
        mode.__exit__(None, None, None)
    finally:
        torch.autograd.set_detect_anomaly(anomaly, check_nan=check_nan)
        _TRACKER.release("nan_checks")


@contextlib.contextmanager
def nan_debugging(enabled=True):
    """enable_nan_debugging for the block (nothing when not `enabled`);
    autograd's NaN error from the backward is raised as FloatingPointError."""
    if not enabled:
        yield
        return
    enable_nan_debugging()
    try:
        yield
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(f"invalid value (nan) encountered in the backward: {e}") from e
        raise
    finally:
        disable_nan_debugging()


@contextlib.contextmanager
def unchecked():
    """The NaN checks' own operations: not checked."""
    _TRACKER.suspended += 1
    try:
        yield
    finally:
        _TRACKER.suspended -= 1


def check_kernel(what, t):
    """Under NaN debugging, raise FloatingPointError naming `what` (a
    kernel) when t holds a NaN; nothing otherwise."""
    if not _NAN_STATE:
        return
    with unchecked():
        if t.numel() and bool(torch.isnan(t).any()):
            raise FloatingPointError(_nan_message(what, t))


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


def _flatten_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):  # the JAX package's order: a dict's keys sorted
            yield from _flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def check_finite(tree, name="tree"):
    """Host-side finite check over nested dicts, lists and tuples of
    tensors, arrays and numbers; raises FloatingPointError with the
    offending path and its NaN / inf counts."""
    for path, leaf in _flatten_with_path(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu()
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            leaf = leaf.to(torch.float64) if leaf.is_floating_point() else leaf
            leaf = leaf.numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind not in "fc":
            continue
        if not np.all(np.isfinite(arr)):
            raise FloatingPointError(
                f"non-finite values in {name}{_keystr(path)}: "
                f"{np.isnan(arr).sum()} NaN / {np.isinf(arr).sum()} inf")

"""Picklable function references — how a restarted server rebuilds task code.

A :class:`~repro_torch.api.jobserver.JobServer` journals each durable job's
plan so that a fresh process can replay it, and the plan's ``fn`` and
``combine`` are lambdas, ``functools.partial`` wrappers and closures, none
of which the stdlib pickler accepts.  This module turns a callable into a
small picklable *reference* that another process resolves back into the
same function:

``("import", module, qualname)``
    A module-level function: the reader imports ``module`` and walks
    ``qualname``.  The cheapest and preferred form.
``("pickle", blob)``
    A builtin the stdlib pickler names but whose qualname does not walk
    back to it (``torch.sum``).
``("partial", inner, args, kwargs)``
    A ``functools.partial`` over an encodable base with picklable statics
    (e.g. ``partial(histogramdd_block, bins=8, lo=0.0, hi=1.0)``).
``("code", module, code_bytes, name, defaults, closure)``
    The fallback for lambdas and closures: the marshalled code object plus
    pickled defaults and closure cell *values*.  The reader rebuilds the
    function against the defining module's ``__dict__`` (so a lambda of
    this package resolves ``torch`` as its module imported it) with fresh
    cells.  In a process that has not imported that module (a spawned
    cluster worker running a combine defined inside a test function), the
    function gets a namespace of its own instead: the modules it names
    (recorded at encoding, beside the defaults) are imported by their own
    names, builtins stay builtins, and only another global imports the
    defining module; a ``global`` write then lands in that namespace, not
    in the module.  A reference written before modules were recorded
    (defaults a pair, not a triple) resolves against the imported defining
    module, as it always did.  Only meaningful between processes running
    the same interpreter.

:func:`encode_fn` returns ``None`` when a callable cannot be referenced
(unpicklable cell values, no code object, ...); callers treat that as
"not durable".  References are hashable.

>>> import functools, operator
>>> ref = encode_fn(functools.partial(operator.add, 2))
>>> decode_fn(ref)(3)
5
"""

from __future__ import annotations

import builtins
import functools
import importlib
import marshal
import pickle
import sys
import types
from typing import Callable

__all__ = ["encode_fn", "decode_fn"]


def _pickled(value) -> bytes | None:
    try:
        return pickle.dumps(value)
    except Exception:  # unpicklable static / cell value
        return None


def _importable(fn: Callable) -> tuple[str, str] | None:
    """(module, qualname) when walking it resolves back to ``fn`` itself."""
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", None)
    if not module or not qualname or "<" in qualname:
        return None
    obj = sys.modules.get(module)
    if obj is None:
        return None
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
    if obj is not fn:
        return None
    return module, qualname


def encode_fn(fn: Callable) -> tuple | None:
    """A picklable, hashable reference to ``fn``, or None if not encodable."""
    if isinstance(fn, functools.partial):
        inner = encode_fn(fn.func)
        if inner is None:
            return None
        args = _pickled(fn.args)
        kwargs = _pickled(tuple(sorted(fn.keywords.items())))
        if args is None or kwargs is None:
            return None
        return ("partial", inner, args, kwargs)

    imp = _importable(fn)
    if imp is not None:
        return ("import", *imp)

    if isinstance(fn, types.BuiltinFunctionType):
        # A builtin whose qualname does not walk back to it (``torch.sum``
        # lives on ``torch._C``'s function class): the pickler names it.
        blob = _pickled(fn)
        if blob is not None and pickle.loads(blob) is fn:
            return ("pickle", blob)
        return None

    code = getattr(fn, "__code__", None)
    module = getattr(fn, "__module__", None)
    if code is None or module is None:
        return None
    try:
        cells = tuple(c.cell_contents for c in fn.__closure__ or ())
    except ValueError:  # empty cell (fn referenced before definition)
        return None
    defaults = _pickled((fn.__defaults__, fn.__kwdefaults__, _module_globals(fn)))
    closure = _pickled(cells)
    if defaults is None or closure is None:
        return None
    return (
        "code",
        module,
        marshal.dumps(code),
        getattr(fn, "__name__", "<fn>"),
        defaults,
        closure,
    )


def _module_globals(fn) -> dict[str, str]:
    """``{global name: module name}`` for the modules ``fn``'s code names.

    >>> import math
    >>> _module_globals(lambda x: math.floor(x))
    {'math': 'math'}
    """
    names: set[str] = set()
    todo = [fn.__code__]
    while todo:
        code = todo.pop()
        names.update(code.co_names)
        todo.extend(c for c in code.co_consts if isinstance(c, types.CodeType))
    env = getattr(fn, "__globals__", {})
    return {
        n: env[n].__name__
        for n in sorted(names)
        if isinstance(env.get(n), types.ModuleType)
    }


class _Namespace(dict):
    """Globals of a function rebuilt away from its defining module.

    Filled lazily: a recorded module global imports that module, a builtin
    falls through to the builtins, and any other name imports the defining
    module and takes its attribute.  So a closure defined in a module that
    imports packages the closure does not use resolves without them.  A
    global's value is taken at its first use, and a ``global`` write stays
    here: neither reaches the defining module.
    """

    def __init__(self, module: str, modules: dict[str, str]):
        super().__init__(__name__=module, __builtins__=builtins)
        self._module = module
        self._modules = modules

    def __missing__(self, name: str):
        if name in self._modules:
            value = importlib.import_module(self._modules[name])
        elif hasattr(builtins, name):
            raise KeyError(name)  # the interpreter looks in builtins next
        else:
            value = getattr(importlib.import_module(self._module), name)
        self[name] = value
        return value


def _globals_for(module: str, modules: dict[str, str]) -> dict:
    """The defining module's namespace where it is loaded, else a lazy one."""
    mod = sys.modules.get(module)
    return mod.__dict__ if mod is not None else _Namespace(module, modules)


def decode_fn(ref: tuple) -> Callable:
    """Resolve a reference produced by :func:`encode_fn` in this process."""
    kind = ref[0]
    if kind == "pickle":
        return pickle.loads(ref[1])
    if kind == "partial":
        _, inner, args, kwargs = ref
        return functools.partial(
            decode_fn(inner), *pickle.loads(args), **dict(pickle.loads(kwargs))
        )
    if kind == "import":
        _, module, qualname = ref
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj
    if kind == "code":
        _, module, code_bytes, name, defaults, closure = ref
        code = marshal.loads(code_bytes)
        dflt, kwdflt, *recorded = pickle.loads(defaults)
        cells = tuple(types.CellType(v) for v in pickle.loads(closure))
        if recorded:
            env = _globals_for(module, recorded[0])
        else:  # written before modules were recorded
            env = importlib.import_module(module).__dict__
        fn = types.FunctionType(code, env, name, dflt, cells or None)
        if kwdflt:
            fn.__kwdefaults__ = dict(kwdflt)
        return fn
    raise ValueError(f"unknown fn reference kind {kind!r}")

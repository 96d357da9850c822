"""Runtime options database (PETSc-options-database equivalent).

The reference framework's load-bearing config mechanism is the PETSc options
database: every numerical choice can be overridden at runtime with
``-flag value`` pairs forwarded from the command line, with string prefixes
scoping sub-solvers (see reference pnode/petsc_adjoint.py:775
``ts.setFromOptions()`` and reference pnode/hpddm_linearsolve.py:15
``ksp.setOptionsPrefix("pnode_inner_")``).

This module rebuilds that capability natively:

- ``init(argv)`` parses a PETSc-style flag tail (``-ts_type cn -ksp_rtol 1e-8``)
  into a global registry, exactly like ``petsc4py.init(sys.argv)`` in every
  reference driver (e.g. reference examples-pnode/ode_demo_petsc.py:63-66).
- Typed getters (`get_string`, `get_real`, `get_int`, `get_bool`) with
  defaults; each access marks the flag as *used* so `options_left()` can warn
  about unrecognized flags (PETSc's ``-options_left`` behavior).
- Prefix scoping: ``Options(prefix="pnode_inner_")`` resolves ``ksp_rtol``
  against ``-pnode_inner_ksp_rtol`` first.

Flags set programmatically (``set_option``) are overridden by command-line
values, matching PETSc's "setFromOptions is called last" convention.

Copy of ``pnode_tpu/options.py`` (the port cannot import the JAX package),
without its XLA compilation-cache hook; ``tests/test_torch_scaffold.py``
pins the two databases to the same behaviour.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Tuple

_TRUE_STRINGS = frozenset({"1", "true", "yes", "on", ""})
_FALSE_STRINGS = frozenset({"0", "false", "no", "off"})


class OptionsDatabase:
    """A global string->string registry with prefix scoping and use tracking."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # command-line values take precedence over programmatic defaults
        self._cli: Dict[str, str] = {}
        self._programmatic: Dict[str, str] = {}
        self._used: set = set()
        # every queried flag with its default: the -help registry (PETSc
        # prints registered options during setFromOptions; here the
        # registry accumulates as objects configure themselves)
        self._registry: Dict[str, str] = {}

    # -- population ------------------------------------------------------

    def parse_argv(self, argv: List[str]) -> List[str]:
        """Consume ``-flag [value]`` pairs; return the non-flag remainder.

        A token starting with ``-`` followed by a letter opens a flag; the next
        token is its value unless it is itself a flag (then the flag is a
        boolean set to ""). Mirrors how PETSc tokenizes its argv tail.
        """
        rest: List[str] = []
        i = 0
        n = len(argv)
        with self._lock:
            while i < n:
                tok = argv[i]
                if _is_flag(tok):
                    name = tok.lstrip("-")
                    if i + 1 < n and not _is_flag(argv[i + 1]):
                        self._cli[name] = argv[i + 1]
                        i += 2
                    else:
                        self._cli[name] = ""
                        i += 1
                else:
                    rest.append(tok)
                    i += 1
        return rest

    def set(self, name: str, value) -> None:
        """Programmatic default (overridden by any command-line value)."""
        with self._lock:
            self._programmatic[name.lstrip("-")] = _to_str(value)

    def set_cli(self, name: str, value) -> None:
        """Force a value at command-line priority (used by tests)."""
        with self._lock:
            self._cli[name.lstrip("-")] = _to_str(value)

    def clear(self) -> None:
        with self._lock:
            self._cli.clear()
            self._programmatic.clear()
            self._used.clear()
            self._registry.clear()

    def delete(self, name: str) -> None:
        with self._lock:
            self._cli.pop(name, None)
            self._programmatic.pop(name, None)

    # -- access ----------------------------------------------------------

    def _register(self, name: str, default) -> None:
        self._registry.setdefault(name, _to_str(default) if default is not None else "")

    def registry(self) -> Dict[str, str]:
        """Queried option names -> default values (the -help listing)."""
        with self._lock:
            return dict(sorted(self._registry.items()))

    def _raw(self, name: str) -> Tuple[bool, Optional[str]]:
        if name in self._cli:
            self._used.add(name)
            return True, self._cli[name]
        if name in self._programmatic:
            self._used.add(name)
            return True, self._programmatic[name]
        return False, None

    def has(self, name: str) -> bool:
        found, _ = self._raw(name.lstrip("-"))
        return found

    def get_string(self, name: str, default: Optional[str] = None) -> Optional[str]:
        self._register(name.lstrip("-"), default)
        found, val = self._raw(name.lstrip("-"))
        return val if found else default

    def get_real(self, name: str, default: Optional[float] = None) -> Optional[float]:
        self._register(name.lstrip("-"), default)
        found, val = self._raw(name.lstrip("-"))
        return float(val) if found and val != "" else default

    def get_int(self, name: str, default: Optional[int] = None) -> Optional[int]:
        self._register(name.lstrip("-"), default)
        found, val = self._raw(name.lstrip("-"))
        return int(val) if found and val != "" else default

    def get_bool(self, name: str, default: bool = False) -> bool:
        self._register(name.lstrip("-"), default)
        found, val = self._raw(name.lstrip("-"))
        if not found:
            return default
        low = str(val).strip().lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(f"option -{name}: cannot parse {val!r} as bool")

    def options_left(self) -> List[str]:
        """Names of CLI flags never queried (PETSc ``-options_left``)."""
        with self._lock:
            return sorted(set(self._cli) - self._used)

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            merged = dict(self._programmatic)
            merged.update(self._cli)
            return merged


def _is_flag(tok: str) -> bool:
    return (
        len(tok) >= 2
        and tok[0] == "-"
        and not tok[1].isdigit()
        and tok[1] != "."
        and tok[1] != "-"  # "--foo" belongs to argparse drivers, not us
    ) or (len(tok) >= 3 and tok.startswith("--") and False)


def _to_str(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    return str(value)


# Global database, PETSc-style.
_db = OptionsDatabase()


_EXIT_HOOKS_SET = False


def _install_exit_hooks() -> None:
    """PETSc parity: ``-options_left`` warns about never-queried flags at
    exit; ``-help`` prints the accumulated option registry at exit (options
    register as objects configure themselves, so exit time is when the
    listing is complete)."""
    global _EXIT_HOOKS_SET
    if _EXIT_HOOKS_SET:
        return
    _EXIT_HOOKS_SET = True
    import atexit

    def _report():
        if _db.has("help"):
            reg = _db.registry()
            vals = _db.snapshot()
            print("pnode_tpu_torch options (queried this run):", file=sys.stderr)
            for name, default in reg.items():
                cur = vals.get(name)
                mark = f" = {cur}" if cur is not None else ""
                print(f"  -{name} (default: {default or '<none>'}){mark}",
                      file=sys.stderr)
        if _db.has("options_left"):
            _db._used.add("options_left")
            _db._used.add("help")
            left = _db.options_left()
            if left:
                print(
                    "WARNING! There are options you set that were not used!",
                    file=sys.stderr,
                )
                for name in left:
                    print(f"  Option left: -{name}", file=sys.stderr)

    atexit.register(_report)


def init(argv: Optional[List[str]] = None) -> List[str]:
    """Parse a PETSc-style option tail into the global database.

    Drivers follow the reference pattern
    (reference examples-pnode/ode_demo_petsc.py:46,63-66)::

        args, unknown = parser.parse_known_args()
        pnode_tpu_torch.init([sys.argv[0]] + unknown)

    Returns the tokens that were not consumed as flags.
    """
    if argv is None:
        argv = sys.argv
    rest = _db.parse_argv(list(argv[1:]))
    if _db.has("options_left") or _db.has("help"):
        _install_exit_hooks()
    return rest


def set_option(name: str, value) -> None:
    _db.set(name, value)


def clear_options() -> None:
    _db.clear()


def options_left() -> List[str]:
    return _db.options_left()


def options_help() -> Dict[str, str]:
    """Queried option names -> defaults (what ``-help`` prints at exit)."""
    return _db.registry()


class Options:
    """Prefix-scoped view of the global database.

    ``Options("pnode_inner_").get_real("ksp_rtol", 1e-5)`` resolves
    ``-pnode_inner_ksp_rtol`` first, then falls back to the default — the
    same scoping the reference's inner HPDDM KSP uses
    (reference pnode/hpddm_linearsolve.py:15).
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def _n(self, name: str) -> str:
        return self.prefix + name.lstrip("-")

    def has(self, name: str) -> bool:
        return _db.has(self._n(name))

    def get_string(self, name: str, default: Optional[str] = None):
        return _db.get_string(self._n(name), default)

    def get_real(self, name: str, default: Optional[float] = None):
        return _db.get_real(self._n(name), default)

    def get_int(self, name: str, default: Optional[int] = None):
        return _db.get_int(self._n(name), default)

    def get_bool(self, name: str, default: bool = False):
        return _db.get_bool(self._n(name), default)

    def set(self, name: str, value) -> None:
        _db.set(self._n(name), value)

"""gatb-style options parser (IOptionsParser/Properties analog).

The reference CLI uses single-dash long options (`-in`, `-kmer-size`, ...)
parsed by gatb's hierarchical IOptionsParser with per-option visibility,
defaults and mandatory flags (composition/hiding/defaults exercised at
reference/src/bcalm_1.cpp:31-43).  argparse cannot express that
surface, so this is a small faithful re-implementation.

Copy of ``bcalm_tpu/utils/options.py`` with the imports pointed at this package
(and the reference's paths given from its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class OptionFailure(Exception):
    """Raised on bad/missing arguments (gatb OptionFailure analog,
    reference/src/bcalm_1.cpp:61)."""


@dataclass
class Option:
    name: str                 # includes leading dash, e.g. "-kmer-size"
    nb_args: int = 1          # 0 => boolean flag (OptionNoParam)
    default: Optional[str] = None
    help: str = ""
    mandatory: bool = False
    visible: bool = True


class Properties:
    """Typed view over parsed option values (gatb IProperties analog)."""

    def __init__(self, values: Dict[str, Any]):
        self._v = dict(values)

    def __contains__(self, name: str) -> bool:
        return name in self._v and self._v[name] is not None

    def get_str(self, name: str, default: Optional[str] = None) -> Optional[str]:
        v = self._v.get(name)
        return default if v is None else str(v)

    def get_int(self, name: str, default: Optional[int] = None) -> Optional[int]:
        v = self._v.get(name)
        return default if v is None else int(v)

    def get_bool(self, name: str) -> bool:
        return bool(self._v.get(name))

    def items(self):
        return self._v.items()


class OptionsParser:
    """Flat parser with gatb semantics: single-dash long names, visibility,
    defaults, mandatory checks, and a usage dump."""

    def __init__(self, name: str):
        self.name = name
        self.options: List[Option] = []
        self._by_name: Dict[str, Option] = {}

    def add(self, opt: Option) -> Option:
        if opt.name in self._by_name:
            raise ValueError(f"duplicate option {opt.name}")
        self.options.append(opt)
        self._by_name[opt.name] = opt
        return opt

    def one_param(self, name, help="", default=None, mandatory=False,
                  visible=True) -> Option:
        return self.add(Option(name, 1, default, help, mandatory, visible))

    def no_param(self, name, help="", visible=True) -> Option:
        return self.add(Option(name, 0, None, help, False, visible))

    def set_default(self, name: str, value) -> None:
        self._by_name[name].default = str(value)

    def set_visible(self, name: str, visible: bool) -> None:
        self._by_name[name].visible = visible

    def parse(self, argv: List[str]) -> Properties:
        values: Dict[str, Any] = {
            o.name: (o.default if o.nb_args else False) for o in self.options
        }
        i = 0
        while i < len(argv):
            tok = argv[i]
            opt = self._by_name.get(tok)
            if opt is None:
                raise OptionFailure(f"unknown option '{tok}'\n{self.usage()}")
            if opt.nb_args == 0:
                values[opt.name] = True
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise OptionFailure(f"option '{tok}' expects a value")
                values[opt.name] = argv[i + 1]
                i += 2
        missing = [
            o.name for o in self.options
            if o.mandatory and values.get(o.name) is None
        ]
        if missing:
            raise OptionFailure(
                f"missing mandatory option(s): {' '.join(missing)}\n{self.usage()}"
            )
        return Properties(values)

    def usage(self) -> str:
        lines = [f"usage: {self.name} [options]", ""]
        for o in self.options:
            if not o.visible:
                continue
            arg = " <arg>" if o.nb_args else ""
            dflt = f" (default: {o.default})" if o.default is not None else ""
            req = " [required]" if o.mandatory else ""
            lines.append(f"  {o.name}{arg:8s} {o.help}{dflt}{req}")
        return "\n".join(lines)

"""The one traffic generator: query instances from a mix file and the
query templates it names, drawn from the run's seed.

A query template (``queries/<name>.json``) holds the SQL text with
``{placeholders}`` on the literals of its selective predicates, the domain
each group of placeholders is drawn from (``params``), and the same query
as a declarative plan for the reference. A mix (``mixes/<traffic>.json``)
names the templates, the number of closed-loop clients and how many
answers a run checks.

Each client is a stream as TPC-DS's throughput test has them: it cycles
the mix's templates in its own seeded permutation and substitutes fresh
parameters into each instance, as ``dsqgen`` does. A group's values are
uniform over its domain, drawn in strata (each cycle of ``STRATA``
instances of a template takes one value from each ``1/STRATA`` of the
domain, in a seeded order), so that every seed covers the domain alike.

Parameter domains: ``{"names": [n], "int": [lo, hi]}`` (an integer in
``lo..hi``); ``{"names": [lo_name, hi_name], "window": [lo, hi, width]}``
(a start in ``lo..hi`` and the start plus ``width - 1``);
``{"names": [a, b, ...], "distinct": [lo, hi]}`` (as many distinct
integers of ``lo..hi``, ascending).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
#: Strata a parameter's domain is cut into.
STRATA = 16
KINDS = ("int", "window", "distinct")


@dataclasses.dataclass(frozen=True)
class Param:
    """One group of placeholders and the domain it is drawn from."""

    names: Tuple[str, ...]
    kind: str
    bounds: Tuple[int, ...]

    @classmethod
    def load(cls, doc: dict) -> "Param":
        kinds = [k for k in KINDS if k in doc]
        if len(kinds) != 1:
            raise ValueError(f"parameter {doc['names']}: one of {KINDS}")
        return cls(tuple(doc["names"]), kinds[0],
                   tuple(int(b) for b in doc[kinds[0]]))

    def values(self, u: float, rng) -> tuple:
        """The group's values at ``u`` in [0, 1) of its domain."""
        lo, hi = self.bounds[:2]
        first = lo + min(int(u * (hi - lo + 1)), hi - lo)
        if self.kind == "int":
            return (first,)
        if self.kind == "window":
            return (first, first + self.bounds[2] - 1)
        rest = [v for v in range(lo, hi + 1) if v != first]
        more = rng.choice(len(rest), len(self.names) - 1, replace=False)
        return tuple(sorted([first] + [rest[i] for i in more]))


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    sql: str
    params: Tuple[Param, ...]
    plan: dict


@dataclasses.dataclass(frozen=True)
class Instance:
    """One query to submit: its template and the values of its
    placeholders."""

    template: Template
    binding: Tuple[Tuple[str, object], ...]

    @property
    def key(self) -> Tuple[str, Tuple[Tuple[str, object], ...]]:
        return self.template.name, self.binding

    @property
    def sql(self) -> str:
        return self.template.sql.format(**dict(self.binding))

    @property
    def plan(self) -> dict:
        return _bind(self.template.plan, dict(self.binding))


def _bind(node, values):
    if isinstance(node, dict):
        return {k: _bind(v, values) for k, v in node.items()}
    if isinstance(node, list):
        return [_bind(v, values) for v in node]
    if isinstance(node, str) and node.startswith("{") and node.endswith("}"):
        return values[node[1:-1]]
    return node


def load_json(kind: str, name: str, root: Path = HERE):
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_template(name: str, root: Path = HERE) -> Template:
    doc = load_json("queries", name, root)
    return Template(doc["name"], "\n".join(doc["sql"]),
                    tuple(Param.load(g) for g in doc["params"]), doc["plan"])


@dataclasses.dataclass
class Mix:
    clients: int
    templates: List[Template]
    check: int

    @classmethod
    def load(cls, name: str, root: Path = HERE) -> "Mix":
        doc = load_json("mixes", name, root)
        return cls(int(doc["clients"]),
                   [load_template(t, root) for t in doc["templates"]],
                   int(doc["check"]))

    def streams(self, seed: int) -> List[Iterator[Instance]]:
        """One endless stream of instances per client."""
        return [self._stream(np.random.default_rng(
                    [int(seed) % (1 << 64), 0xC11E, c]))
                for c in range(self.clients)]

    def _stream(self, rng) -> Iterator[Instance]:
        order = [self.templates[i]
                 for i in rng.permutation(len(self.templates))]
        strata: Dict[Tuple[str, Tuple[str, ...]], list] = {}
        while True:
            for t in order:
                binding = []
                for p in t.params:
                    left = strata.setdefault((t.name, p.names), [])
                    if not left:
                        left.extend(rng.permutation(STRATA).tolist())
                    u = (left.pop() + rng.random()) / STRATA
                    binding.extend(zip(p.names, p.values(u, rng)))
                yield Instance(t, tuple(binding))

    def first_instances(self) -> List[Instance]:
        """Each template once, each group at the middle of its domain: the
        warm-up."""
        rng = np.random.default_rng(0)
        return [Instance(t, tuple(b for p in t.params
                                  for b in zip(p.names, p.values(0.5, rng))))
                for t in self.templates]

"""The sharding rule table: which dimension each weight leaf is cut along
under tensor parallelism, and where.

An ordered table of ``(leaf-path regex -> cut)`` rules per params layout,
resolved with exactly one match per leaf: a leaf no rule names raises
:class:`UnmatchedLeafError` and a leaf two rules name raises
:class:`AmbiguousLeafError`, so no matrix is ever replicated by accident.
A cut is the index of the dimension split into ``tp`` equal parts (rank r
holds part r), or None for a replicated leaf.

Every matmul layout stores its output dimension last (q40 packs
[n_pad/2, d_pad], plain weights [d_in, d_out]), so a cut on the last
dimension is an output shard (the reference's RowMatmulSlice: q/k/v and
gate/up, and wcls over the vocab) and a cut on the first an input shard
(ColMatmulSlice: wo and down). Layouts ported: ``q40`` (fused qkv and
gate_up, one QuantizedMatrix leaf each, whose nibbles and scales cut
alike) and ``layered`` (the f32/bf16 per-matrix leaves). The KV cache
cuts its kv-head axis (:data:`CACHE_KV_HEAD_AXIS`).
"""

from __future__ import annotations

import dataclasses
import re

# the q40 pack of matrix [n, d] keeps n/2 packed rows x d columns and n/32
# scale rows x d columns, so both of its tensors cut along the same axis as
# the logical [n, d] matrix
OUT = 1  # output (last) dimension of a [d_in, d_out] matmul leaf
IN = 0  # input dimension


class ShardingRuleError(TypeError):
    """A weight leaf the rule table cannot place."""


class UnmatchedLeafError(ShardingRuleError):
    """A leaf no rule matched."""


class AmbiguousLeafError(ShardingRuleError):
    """A leaf two or more rules matched."""


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str
    cut: int | None

    def matches(self, path: str) -> bool:
        return re.fullmatch(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """An ordered, exactly-one-match rule set for one params layout."""

    name: str
    rules: tuple[Rule, ...]

    def cut(self, path: str) -> int | None:
        """The dimension leaf ``path`` ('/'-joined) is cut along, or None."""
        hits = [r for r in self.rules if r.matches(path)]
        if not hits:
            raise UnmatchedLeafError(f"sharding table {self.name!r}: weight leaf {path!r} matches no rule")
        if len(hits) > 1:
            raise AmbiguousLeafError(
                f"sharding table {self.name!r}: weight leaf {path!r} matches {[r.pattern for r in hits]}")
        return hits[0].cut


_L = r"layers/\d+"
LAYOUTS = ("q40", "layered")


def param_rules(layout: str, shard_vocab: bool) -> RuleTable:
    """The rule table of one params layout; ``shard_vocab`` cuts wcls over
    the vocab (when the vocab divides by tp)."""
    if layout == "q40":
        layer = (Rule(rf"{_L}/(qkv|gate_up)", OUT), Rule(rf"{_L}/(wo|down)", IN))
    elif layout == "layered":
        layer = (Rule(rf"{_L}/(q|k|v|gate|up)", OUT), Rule(rf"{_L}/(wo|down)", IN))
    else:
        raise ValueError(f"unknown params layout {layout!r} (one of {LAYOUTS})")
    return RuleTable(f"{layout}/llama", (
        Rule(r"embedding", None),
        Rule(r"rms_final", None),
        Rule(r"rope_table", None),
        Rule(r"wcls", OUT if shard_vocab else None),
        Rule(rf"{_L}/(rms_att|rms_ffn)", None),
        *layer,
    ))


# the per-layer fused cache leaf [2, S, K, hd] (and an int8 leaf's scales
# [2, S, K, 1]) cuts its kv-head axis
CACHE_KV_HEAD_AXIS = 2

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

A MoE table (Mixtral, Grok-1) replicates the router and gives every rank
a hidden slice of every expert: under q40 each expert's fused gate|up pack
is output-sharded and its down input-sharded; the f32/bf16 expert banks
[E, d_in, d_out] cut their out dimension (:data:`BANK_OUT`: moe_up,
moe_gate) or their in dimension (:data:`BANK_IN`: moe_down).

Expert parallelism (:func:`ep_rules`) adds a second cut over the ``ep``
ranks: whole experts, the hidden slice of each still cut over ``tp`` as
above (the JAX package's ``ep``/``ep_q40`` layouts: experts over the
expert axis, hidden over the model axis). Sequence parallelism cuts the
cache's sequence axis over the ``sp`` ranks (:data:`CACHE_SEQ_AXIS`, the
JAX ``stream_sp`` rule) and replicates every weight over them.
"""

from __future__ import annotations

import dataclasses
import re

# the q40 pack of matrix [n, d] keeps n/2 packed rows x d columns and n/32
# scale rows x d columns, so both of its tensors cut along the same axis as
# the logical [n, d] matrix
OUT = 1  # output (last) dimension of a [d_in, d_out] matmul leaf
IN = 0  # input dimension
BANK_OUT = 2  # output dimension of a stacked [E, d_in, d_out] expert bank
BANK_IN = 1  # its input dimension


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


_E = r"experts/\d+"


def param_rules(layout: str, shard_vocab: bool, moe: bool = False) -> RuleTable:
    """The rule table of one params layout; ``shard_vocab`` cuts wcls over
    the vocab (when the vocab divides by tp); ``moe`` names the MoE layers'
    router, expert leaves and Grok-1's two extra norms in place of the
    dense FFN."""
    if layout == "q40":
        attn = (Rule(rf"{_L}/qkv", OUT), Rule(rf"{_L}/wo", IN))
        ffn = (Rule(rf"{_L}/{_E}/gate_up", OUT), Rule(rf"{_L}/{_E}/down", IN)) if moe else (
            Rule(rf"{_L}/gate_up", OUT), Rule(rf"{_L}/down", IN))
    elif layout == "layered":
        attn = (Rule(rf"{_L}/(q|k|v)", OUT), Rule(rf"{_L}/wo", IN))
        ffn = (Rule(rf"{_L}/(moe_up|moe_gate)", BANK_OUT), Rule(rf"{_L}/moe_down", BANK_IN)) if moe else (
            Rule(rf"{_L}/(gate|up)", OUT), Rule(rf"{_L}/down", IN))
    else:
        raise ValueError(f"unknown params layout {layout!r} (one of {LAYOUTS})")
    norms = "rms_att|rms_ffn|rms_moe|rms_ffn2" if moe else "rms_att|rms_ffn"
    return RuleTable(f"{layout}/{'moe' if moe else 'llama'}", (
        Rule(r"embedding", None),
        Rule(r"rms_final", None),
        Rule(r"rope_table", None),
        Rule(r"wcls", OUT if shard_vocab else None),
        Rule(rf"{_L}/({norms})", None),
        *((Rule(rf"{_L}/router", None),) if moe else ()),
        *attn,
        *ffn,
    ))


def ep_rules(layout: str) -> RuleTable:
    """Which leaves expert parallelism cuts over its ``ep`` ranks: every
    expert leaf, along :data:`EXPERT` (a stacked bank's leading axis, or
    the index of a q40 expert in its layer's ``experts`` list: rank j owns
    experts [j*E/ep, (j+1)*E/ep)); every other leaf is replicated over ep."""
    if layout == "q40":
        expert = rf"{_L}/{_E}/(gate_up|down)"
    elif layout == "layered":
        expert = rf"{_L}/moe_(up|gate|down)"
    else:
        raise ValueError(f"unknown params layout {layout!r} (one of {LAYOUTS})")
    return RuleTable(f"{layout}/ep", (Rule(expert, EXPERT), Rule(rf"(?!{expert}$).*", None)))


# the expert axis of expert parallelism: a bank's leading axis, a q40
# expert's list index
EXPERT = 0

# the per-layer fused cache leaf [2, S, K, hd] (and an int8 leaf's scales
# [2, S, K, 1]) cuts its kv-head axis over tp and, under sequence
# parallelism, its sequence axis over sp (rank i holds slots
# [i*S/sp, (i+1)*S/sp))
CACHE_KV_HEAD_AXIS = 2
CACHE_SEQ_AXIS = 1

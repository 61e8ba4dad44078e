"""Shared protocol CLI flags and their parse-time checks (port of
``repro.api.cli``).

Every training CLI of the port (``repro_torch.launch.train``) takes the
same deployment flags from here, so an invalid combination dies as a parser
error with an actionable message, not as a traceback from inside
``Session.build``.

It also holds the **topology registry**: :func:`make_topology` maps a name
to the paper circulants (``dout``, ``exp``; the older ``K-out`` spelling
means ``dout`` with degree K), the classic graphs (``ring``, ``full``) and
the :mod:`repro_torch.net` families (``er``, ``matching``, ``torus``,
``smallworld``); :func:`add_topology_arguments` adds the ``--topology``
flag with each family's knobs, and :func:`topology_from_args` turns a bad
knob (a prime-N torus, an ER probability out of range) into a parser
error.

One difference from the reference: :func:`validate_protocol_args` takes
the compress-first codec with ``--use-kernels``, which the reference
refuses. The port's kernel route runs that codec (its encode before the
down-scaled noise), so the combination is a valid run here.
"""
from __future__ import annotations

import argparse
from typing import Any

__all__ = [
    "TOPOLOGY_CHOICES",
    "add_protocol_arguments",
    "validate_protocol_args",
    "add_topology_arguments",
    "topology_from_args",
    "make_topology",
    "add_fault_arguments",
    "faults_from_args",
    "add_delay_arguments",
    "delays_from_args",
    "wire_from_args",
]

# The --topology vocabulary: the paper circulants (dout, exp), the classic
# deterministic graphs (ring, full) and the repro_torch.net random and
# structured families (er, matching, torus, smallworld).
TOPOLOGY_CHOICES = ("dout", "exp", "ring", "full", "er", "matching",
                    "torus", "smallworld")


def make_topology(name: str, n_nodes: int, *, degree: int = 2,
                  p: float = 0.3, matchings: int = 1, beta: float = 0.1,
                  rows: int = 0, seed: int = 0, period: int = 0) -> Any:
    """The name -> Topology registry (see the module docstring).

    ``period > 0`` wraps a seeded random family in
    :class:`repro_torch.net.RandomSequenceTopology`, which redraws the
    graph every round with that cycle length (and raises for the unseeded
    families). The constructors raise ``ValueError`` for bad knobs;
    :func:`topology_from_args` turns those into parser errors.
    """
    # imported here: repro_torch.net imports repro_torch.api (its hook)
    from repro_torch.core.topology import (DOutGraph, ExpGraph,
                                           FullyConnectedGraph, RingGraph)
    from repro_torch.net.graphs import (ErdosRenyiGraph, RandomMatchingGraph,
                                        RandomSequenceTopology,
                                        SmallWorldGraph, TorusGraph)

    name = name.lower()
    if name.endswith("-out"):  # the older benchmark spelling: "2-out"
        degree, name = int(name.split("-")[0]), "dout"
    if name == "dout":
        topo = DOutGraph(n_nodes=n_nodes, d=degree)
    elif name == "exp":
        topo = ExpGraph(n_nodes=n_nodes)
    elif name == "ring":
        topo = RingGraph(n_nodes=n_nodes)
    elif name == "full":
        topo = FullyConnectedGraph(n_nodes=n_nodes)
    elif name == "er":
        topo = ErdosRenyiGraph(n_nodes=n_nodes, p=p, seed=seed)
    elif name == "matching":
        topo = RandomMatchingGraph(n_nodes=n_nodes, k=matchings, seed=seed)
    elif name == "smallworld":
        topo = SmallWorldGraph(n_nodes=n_nodes, beta=beta, seed=seed)
    elif name == "torus":
        topo = TorusGraph(n_nodes=n_nodes, rows=rows)
    else:
        raise ValueError(
            f"unknown topology {name!r}; choose from {TOPOLOGY_CHOICES} "
            "(or the legacy 'K-out' spelling for dout)")
    if period > 0:
        topo = RandomSequenceTopology(n_nodes=n_nodes, base=topo,
                                      period=period)
    return topo


def add_protocol_arguments(ap: argparse.ArgumentParser, *,
                           chunk: int = 50) -> None:
    """Attach the shared engine and runtime flags to ``ap``."""
    ap.add_argument("--chunk", type=int, default=chunk,
                    help="rounds per engine segment")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the engine over the packed (N, d_s) wire "
                         "buffer (--no-packed keeps the pytree runtime)")
    ap.add_argument("--wire", type=str, default="f32", metavar="SPEC",
                    help="wire codec spec (repro_torch.wire): f32 | bf16 | "
                         "int8 | topk:K | topk:1/M. Compression is applied "
                         "strictly after DP noise (noise-then-compress); "
                         "needs --packed and --driver engine")
    ap.add_argument("--wire-dtype", choices=("f32", "bf16"), default="f32",
                    help="deprecated: subsumed by --wire (use --wire bf16)")


def wire_from_args(ap: argparse.ArgumentParser,
                   args: argparse.Namespace) -> Any:
    """The WireCodec of ``--wire`` (or the deprecated ``--wire-dtype``), or
    None for the raw f32 wire.

    ``--wire-dtype bf16`` maps to the bf16 codec with one
    DeprecationWarning a process; a conflicting explicit ``--wire`` spec,
    or a bad one, dies as a parser error naming the vocabulary.
    """
    from repro_torch.engine.plan import _warn_once
    from repro_torch.wire import parse_wire_spec

    spec = getattr(args, "wire", "f32") or "f32"
    try:
        codec = parse_wire_spec(spec)
    except ValueError as e:
        ap.error(f"--wire {spec!r}: {e}")
    legacy = getattr(args, "wire_dtype", "f32")
    if legacy != "f32":
        _warn_once("cli_wire_dtype",
                   "--wire-dtype bf16 is deprecated; use --wire bf16")
        if not codec.active:
            codec = parse_wire_spec(legacy)
        elif codec.name != legacy:
            ap.error(f"--wire {spec} conflicts with the deprecated "
                     f"--wire-dtype {legacy}; drop --wire-dtype")
    return codec if codec.active else None


def validate_protocol_args(ap: argparse.ArgumentParser,
                           args: argparse.Namespace) -> None:
    """Refuse invalid flag combinations with an actionable parser error.

    The plan's invariants, checked at parse time:
      * a non-f32 wire codec needs the packed runtime: every codec is a
        transform of the packed (N, d_s) buffer;
      * it needs the engine driver: the per-round loop runs the pytree
        runtime;
      * a dtype-cast codec (bf16) does not compose with the async mailbox
        (--max-delay / --timeout-rate / --node-rates), whose calendars
        accumulate in f32; the value codecs (int8, topk) do;
      * chunk must be a positive segment length.
    The compress-first codec with ``--use-kernels`` is taken (module
    docstring).
    """
    if getattr(args, "chunk", 1) < 1:
        ap.error("--chunk must be >= 1")
    codec = wire_from_args(ap, args)
    if codec is None:
        return
    name = codec.name
    if not getattr(args, "packed", True):
        ap.error(
            f"--wire {name} requires the packed runtime: every wire codec "
            "is a transform of the packed (N, d_s) buffer. Drop "
            "--no-packed, or use --wire f32 (legacy: --wire-dtype f32) "
            "with the pytree path.")
    if getattr(args, "driver", "engine") != "engine":
        ap.error(
            f"--wire {name} requires --driver engine: the per-round "
            "loop driver runs the pytree reference path, which is f32-only.")
    async_on = (getattr(args, "max_delay", 0)
                or getattr(args, "timeout_rate", 0.0)
                or getattr(args, "node_rates", ""))
    if async_on and not codec.transforms_values:
        ap.error(
            f"--wire {name} does not compose with the async mailbox "
            "runtime: the mailbox calendars accumulate in-flight mass in "
            "f32. Use a value codec (--wire int8, --wire topk:K) or drop "
            "the delay flags.")


def add_topology_arguments(ap: argparse.ArgumentParser, *,
                           default: str = "dout") -> None:
    """Attach the shared --topology flag and its families' knobs."""
    ap.add_argument("--topology", choices=TOPOLOGY_CHOICES, default=default,
                    help="communication graph family (repro_torch.api.cli "
                         "registry; er/matching/smallworld/torus are the "
                         "repro_torch.net families)")
    ap.add_argument("--degree", type=int, default=2,
                    help="dout: out-degree incl. the self loop")
    ap.add_argument("--er-p", type=float, default=0.3,
                    help="er: edge probability")
    ap.add_argument("--matchings", type=int, default=1,
                    help="matching: number of random cycles unioned")
    ap.add_argument("--sw-beta", type=float, default=0.1,
                    help="smallworld: Watts-Strogatz rewiring probability")
    ap.add_argument("--torus-rows", type=int, default=0,
                    help="torus: grid rows (0 = most-square factorization)")
    ap.add_argument("--graph-seed", type=int, default=0,
                    help="seed of the random graph families")
    ap.add_argument("--resample-period", type=int, default=0,
                    help="resample the random graph every round, cycling "
                         "with this period (0 = static draw)")


def topology_from_args(ap: argparse.ArgumentParser, args: argparse.Namespace,
                       n_nodes: int) -> Any:
    """The registry's topology of the flags (a bad knob: parser error)."""
    try:
        return make_topology(
            args.topology, n_nodes, degree=args.degree, p=args.er_p,
            matchings=args.matchings, beta=args.sw_beta,
            rows=args.torus_rows, seed=args.graph_seed,
            period=args.resample_period)
    except ValueError as e:
        ap.error(f"--topology {args.topology}: {e}")


def add_fault_arguments(ap: argparse.ArgumentParser) -> None:
    """Attach the fault-injection flags (repro_torch.net.faults)."""
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-edge Bernoulli link-drop probability per round")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="per-node probability a round's messages miss the "
                         "deadline (outgoing edges dropped, renormalized)")
    ap.add_argument("--churn", action="append", default=[],
                    metavar="NODE:T_DOWN:T_UP",
                    help="deterministic downtime window: node NODE is down "
                         "for rounds [T_DOWN, T_UP) (repeatable)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault stream (distinct streams for "
                         "repeated studies on one base key)")


def _parse_churn(ap: argparse.ArgumentParser, specs: list[str],
                 n_nodes: int | None) -> tuple[tuple[int, int, int], ...]:
    """``NODE:T_DOWN:T_UP`` strings -> churn triples, checked at parse time."""
    churn = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) != 3:
            ap.error(f"--churn {spec!r}: expected NODE:T_DOWN:T_UP "
                     "(three ints separated by colons)")
        try:
            node, t_down, t_up = (int(p) for p in parts)
        except ValueError:
            ap.error(f"--churn {spec!r}: NODE, T_DOWN and T_UP must be ints")
        if n_nodes is not None and not 0 <= node < n_nodes:
            ap.error(f"--churn {spec!r}: node {node} out of range for "
                     f"n_nodes={n_nodes}")
        churn.append((node, t_down, t_up))
    return tuple(churn)


def faults_from_args(ap: argparse.ArgumentParser, args: argparse.Namespace,
                     n_nodes: int | None = None) -> Any:
    """The FaultModel of the flags, or None when every knob is off.

    ``n_nodes`` (when known at parse time) checks the ``--churn`` node ids
    against the topology's size.
    """
    churn = _parse_churn(ap, args.churn, n_nodes)
    if not (args.drop_rate or args.straggler_rate or churn):
        return None
    from repro_torch.net.faults import FaultModel

    try:
        return FaultModel(drop_rate=args.drop_rate,
                          straggler_rate=args.straggler_rate,
                          churn=churn, seed=args.fault_seed)
    except ValueError as e:
        ap.error(str(e))


def add_delay_arguments(ap: argparse.ArgumentParser) -> None:
    """Attach the bounded-delay async flags (repro_torch.net.delays)."""
    ap.add_argument("--max-delay", type=int, default=0,
                    help="staleness bound B: sent messages get a uniform "
                         "random delay in {0..B} rounds (0 = synchronous)")
    ap.add_argument("--timeout-rate", type=float, default=0.0,
                    help="per-message probability of exceeding the "
                         "staleness bound; the mass re-credits the "
                         "sender's self-loop")
    ap.add_argument("--node-rates", type=str, default="",
                    help="comma-separated per-node round rates (node i "
                         "participates every r_i rounds); empty = every "
                         "node every round")
    ap.add_argument("--delay-seed", type=int, default=0,
                    help="seed of the delay/timeout stream")


def delays_from_args(ap: argparse.ArgumentParser, args: argparse.Namespace,
                     n_nodes: int | None = None) -> Any:
    """The DelayModel of the flags, or None when every knob is off.

    ``n_nodes`` checks the length of ``--node-rates`` at parse time.
    """
    rates: tuple[int, ...] = ()
    if args.node_rates:
        try:
            rates = tuple(int(r) for r in args.node_rates.split(","))
        except ValueError:
            ap.error(f"--node-rates {args.node_rates!r}: expected "
                     "comma-separated ints (one rate per node)")
        if n_nodes is not None and len(rates) != n_nodes:
            ap.error(f"--node-rates has {len(rates)} entries but "
                     f"n_nodes={n_nodes}; give one rate per node")
    if not (args.max_delay or args.timeout_rate
            or any(r > 1 for r in rates)):
        return None
    from repro_torch.net.delays import DelayModel

    try:
        return DelayModel(max_delay=args.max_delay,
                          timeout_rate=args.timeout_rate,
                          rates=rates, seed=args.delay_seed)
    except ValueError as e:
        ap.error(str(e))

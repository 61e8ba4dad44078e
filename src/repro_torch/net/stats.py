"""NetworkStats: what the network did during a run (port of
``repro.net.stats``).

* :class:`NetworkStats`: realized edges a round, dropped edges, the
  smallest realized out-degree, Assumption-1 connectivity of the realized
  graphs over windows of B rounds, and the bytes that crossed the wire
  beside the fault-free figure on the same topology.
* :class:`NetworkStatsHook`: the session hook that gathers them
  (``needs_adjacency``: the round emits its realized (N, N) adjacency),
  and publishes the realized and dropped edge counts (``net.*``) and, under
  delays, the staleness histogram, timeouts and participation on the
  metrics bus.

A fault-free run gets stats too: without ``net_*`` rows the hook rebuilds
the nominal adjacency of each round from the plan. The session attaches
``network_stats()`` to ``RunReport.network``. A message's bytes follow the
plan's wire codec or wire dtype, as ``estimate_wire_bytes`` counts them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.api.hooks import RoundHook, _resolve_bus

__all__ = ["NetworkStats", "NetworkStatsHook", "strongly_connected"]


def strongly_connected(adj: np.ndarray) -> bool:
    """Strong connectivity of a (receiver, sender) adjacency, by boolean
    powers."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    reach = adj | np.eye(n, dtype=bool)
    for _ in range(max(n.bit_length(), 1)):
        nxt = reach | (reach @ reach)
        if (nxt == reach).all():
            break
        reach = nxt
    return bool(reach.all())


@dataclasses.dataclass
class NetworkStats:
    """The realized network of one run (per-round arrays of length T).
    ``nominal_bytes`` is the fault-free traffic on the same topology (the
    realized plus the dropped edges), so ``effective_bytes /
    nominal_bytes`` isolates what the faults removed."""

    rounds: int
    n_nodes: int
    b_window: int
    realized_edges: np.ndarray       # (T,) non-self directed edges that fired
    dropped_edges: np.ndarray        # (T,) nominal minus realized edges
    out_degree_min: np.ndarray       # (T,) smallest realized sender degree
    connected_windows: int           # B-windows whose union graph is strong
    windows: int                     # B-windows checked
    effective_bytes: int             # realized edges x message payload
    nominal_bytes: int               # the same on the fault-free support
    wire_codec: str = "f32"
    payload_bytes: int = 0           # message bytes
    compression_ratio: float = 1.0   # raw f32 message bytes / payload

    @property
    def all_windows_connected(self) -> bool:
        return self.windows > 0 and self.connected_windows == self.windows

    @property
    def drop_fraction(self) -> float:
        total = self.realized_edges.sum() + self.dropped_edges.sum()
        return float(self.dropped_edges.sum() / total) if total else 0.0

    def summary(self) -> dict[str, Any]:
        return {
            "rounds": self.rounds,
            "n_nodes": self.n_nodes,
            "b_window": self.b_window,
            "realized_edges_mean": float(self.realized_edges.mean())
            if self.rounds else 0.0,
            "dropped_edges_total": int(self.dropped_edges.sum()),
            "drop_fraction": round(self.drop_fraction, 4),
            "out_degree_min": int(self.out_degree_min.min())
            if self.rounds else 0,
            "connected_windows": f"{self.connected_windows}/{self.windows}",
            "all_windows_connected": self.all_windows_connected,
            "effective_bytes": self.effective_bytes,
            "nominal_bytes": self.nominal_bytes,
            "wire_codec": self.wire_codec,
            "payload_bytes": self.payload_bytes,
            "compression_ratio": round(self.compression_ratio, 3),
        }


class NetworkStatsHook(RoundHook):
    """Gather :class:`NetworkStats` from a session run.

    ``b_window``: the window the connectivity check slides over the
    realized graphs (default: the plan's period). ``bus``: the metrics bus
    (default: the process-wide one).
    """

    needs_adjacency = True

    def __init__(self, b_window: int | None = None, *, bus: Any = None):
        self.b_window = b_window
        self.bus = bus
        self._adj: list[np.ndarray] = []
        self._out_deg: list[np.ndarray] = []
        self._dropped: list[np.ndarray] = []
        self._ctx = None

    def prepare(self, ctx) -> None:
        self._ctx = ctx

    def _publish_async(self, rows: dict[str, Any], t0: int) -> None:
        """Delays: the staleness histogram (one weighted observation a delay
        bin a segment), the timeout counter and the participation gauge."""
        if "async_delay_hist" not in rows:
            return
        hist = np.asarray(rows["async_delay_hist"])          # (T, B+1)
        t_last = t0 + hist.shape[0] - 1
        bus = self.bus = _resolve_bus(self.bus)
        for d in range(hist.shape[1]):
            delivered = int(hist[:, d].sum())
            if delivered:
                bus.observe("net.staleness", float(d), count=delivered,
                            round=t_last)
        bus.count("net.timeouts",
                  int(np.asarray(rows["async_timeouts"]).sum()),
                  round=t_last)
        bus.gauge("net.participation",
                  float(np.asarray(rows["async_participated"]).mean()),
                  round=t_last)

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        self._publish_async(rows, t0)
        if "net_adj" in rows:
            adj = np.asarray(rows["net_adj"], dtype=bool)
            out_deg = np.asarray(rows["net_out_degree"])
            dropped = np.asarray(rows["net_dropped_edges"])
        elif "net_out_degree" in rows:
            raise ValueError(
                "faulted trajectory carries no net_adj rows — this hook's "
                "needs_adjacency was overridden to False; the realized "
                "window-connectivity check needs the per-round adjacency")
        else:
            n_rounds = int(np.asarray(
                next(iter(rows.values()))).shape[0]) if rows else 0
            adj, out_deg, dropped = self._nominal_rows(t0, n_rounds)
        self._adj.append(adj)
        self._out_deg.append(out_deg)
        self._dropped.append(dropped)
        if adj.shape[0]:
            eye = np.eye(adj.shape[1], dtype=bool)
            t_last = t0 + adj.shape[0] - 1
            bus = self.bus = _resolve_bus(self.bus)
            bus.count("net.realized_edges",
                      int((adj & ~eye).sum()), round=t_last)
            bus.count("net.dropped_edges", int(dropped.sum()), round=t_last)
            bus.gauge("wire.compression_ratio", self._wire_payload()[2],
                      round=t_last)

    def _nominal_rows(self, t0: int, n_rounds: int):
        """Fault-free rounds: the realized graph is the nominal one, rebuilt
        from the plan."""
        plan, n = self._ctx.plan, self._ctx.n_nodes
        adj = np.zeros((n_rounds, n, n), dtype=bool)
        idx = np.arange(n)
        for i in range(n_rounds):
            r = (t0 + i) % max(int(plan.period), 1)
            if plan.schedule == "circulant":
                wts = plan.mix_weights[r].cpu().numpy()
                for off, wt in zip(plan.offsets, wts):
                    if wt > 0:
                        adj[i, (idx + off) % n, idx] = True
            elif plan.sparse_idx is not None:
                # slot (receiver, k) is an edge iff its weight is positive
                send = plan.sparse_idx[r].cpu().numpy()     # (N, K)
                live = plan.sparse_vals[r].cpu().numpy() > 0.0
                recv = np.broadcast_to(idx[:, None], send.shape)
                adj[i, recv[live], send[live]] = True
            else:
                adj[i] = plan.ws[r].cpu().numpy() > 0.0
        eye = np.eye(n, dtype=bool)
        out_deg = (adj & ~eye).sum(axis=1)  # (T, N) a sender column
        adj |= eye
        return adj, out_deg, np.zeros((n_rounds,), dtype=np.int64)

    def _wire_payload(self) -> tuple[str, int, float]:
        """(codec name, message bytes after compression, compression ratio
        against the raw 4-byte f32 message): an active codec of the plan
        owns the bytes, else the wire dtype does."""
        d_s = int(getattr(self._ctx, "d_s", 0) or 0)
        codec = getattr(self._ctx.plan, "wire", None)
        if codec is not None and getattr(codec, "active", False):
            name, msg_bytes = codec.name, int(codec.payload_bytes(d_s))
        else:
            name = self._ctx.cfg.wire_dtype
            msg_bytes = d_s * (2 if name == "bf16" else 4)
        ratio = (4.0 * d_s / msg_bytes) if msg_bytes else 1.0
        return name, msg_bytes, ratio

    def network_stats(self) -> NetworkStats | None:
        if self._ctx is None or not self._adj:
            return None
        adj = np.concatenate(self._adj, axis=0)
        out_deg = np.concatenate(self._out_deg, axis=0)
        dropped = np.concatenate(self._dropped, axis=0)
        rounds, n = adj.shape[0], adj.shape[1]
        eye = np.eye(n, dtype=bool)
        realized = (adj & ~eye).sum(axis=(1, 2))
        b = int(self.b_window or max(int(self._ctx.plan.period), 1))
        windows = connected = 0
        for w0 in range(0, rounds - b + 1, b):
            windows += 1
            connected += int(strongly_connected(adj[w0:w0 + b].any(axis=0)))
        codec_name, msg_bytes, ratio = self._wire_payload()
        payload = msg_bytes + 8  # message + the a_i and S_i scalars
        nominal_edges = int(realized.sum() + dropped.sum())
        return NetworkStats(
            rounds=rounds, n_nodes=n, b_window=b,
            realized_edges=realized, dropped_edges=dropped,
            out_degree_min=out_deg.min(axis=1) if rounds else out_deg,
            connected_windows=connected, windows=windows,
            effective_bytes=int(realized.sum()) * payload,
            nominal_bytes=nominal_edges * payload,
            wire_codec=codec_name, payload_bytes=msg_bytes,
            compression_ratio=ratio)

"""HierTrain per-iteration training-time cost model — Eqs. (1)-(12) of the
paper, plus the M-device generalization (DESIGN.md §6).

Conventions
-----------
* The paper's topology has exactly three physical workers — ``"device"``,
  ``"edge"``, ``"cloud"`` (indices 0/1/2) — captured by
  :class:`HierProfile` / :class:`Network` / :class:`Schedule` and scored by
  :func:`_t_total` / :func:`_t_total_batch`.
* The generalized topology has ``M`` heterogeneous devices in a star around
  one edge server, which uplinks to one cloud — captured by
  :class:`MultiProfile` / :class:`StarNetwork` / :class:`MultiSchedule` and
  scored by :func:`_t_total_multi` / :func:`_t_total_multi_batch`.  With
  ``M = 1`` the generalized model evaluates to the three-worker model
  bit-for-bit (the M=1 equivalence suite asserts it).
* Roles are ``o`` (TASK O, full model, owner), ``s`` (TASK S, layers
  ``1..m_s`` — one such task per non-``o``/non-``l`` worker in the
  generalized model, each with its own cut ``m_s[i]``), ``l`` (TASK L,
  layers ``1..m_l``), with ``0 <= m_s[i] <= m_l <= N``.
* Layers are 1-indexed in the paper; arrays here are 0-indexed, so layer ``i``
  lives at index ``i-1``.  ``MO[i-1]`` is the forward output size (bytes per
  sample) of layer ``i``; ``MP[i-1]`` its parameter bytes.
* All times in seconds, sizes in bytes, bandwidths in bytes/second.

Any path between workers without a direct physical link is the series
composition of the links through the edge (data is relayed — Fig. 1(c)
topology); the paper's Algorithm 1 only takes ``BW_de`` and ``BW_ec`` as
inputs, the star network takes one uplink bandwidth per device.

Everything here scores ONE iteration in isolation (barrier execution).
The steady-state cost of *pipelined* consecutive minibatches —
``t_period`` and friends — lives in :mod:`repro_torch.core.pipeline`
(DESIGN.md §7) and consumes the same profile/network/schedule types.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

WORKERS: Tuple[str, str, str] = ("device", "edge", "cloud")
WIDX: Dict[str, int] = {w: i for i, w in enumerate(WORKERS)}


@dataclasses.dataclass
class HierProfile:
    """Profiling-stage output (§III, profiling stage).

    Attributes
    ----------
    L_f, L_b : ``[3, N]`` — forward/backward seconds *per sample* per layer
        per worker (``L^f_{j,i}``, ``L^b_{j,i}``).
    L_u : ``[3, N]`` — weight-update seconds per layer per worker
        (``L^u_{j,i}``; batch-size independent).
    MP : ``[N]`` — parameter bytes per layer (``MP_i``).
    MO : ``[N]`` — forward-output bytes per *sample* per layer (``MO_i``).
    MG : ``[N]`` — backward wire bytes per *sample* at each cut (the
        activation *gradient* shipped from worker_o back to a TASK-S/L
        worker).  ``None`` (the default) means "equal to ``MO``" — the
        paper's §IV-C assumption, under which every cost is bitwise
        identical to the historical MO-only model.  LM profiles set it
        explicitly (bf16 activations forward, f32 gradients back).
    sample_bytes : ``Q`` — bytes of one training sample (input + label).
    """
    layer_names: Tuple[str, ...]
    L_f: np.ndarray
    L_b: np.ndarray
    L_u: np.ndarray
    MP: np.ndarray
    MO: np.ndarray
    sample_bytes: float
    MG: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.L_f = np.asarray(self.L_f, np.float64)
        self.L_b = np.asarray(self.L_b, np.float64)
        self.L_u = np.asarray(self.L_u, np.float64)
        self.MP = np.asarray(self.MP, np.float64)
        self.MO = np.asarray(self.MO, np.float64)
        self.MG = self.MO if self.MG is None \
            else np.asarray(self.MG, np.float64)
        n = self.num_layers
        assert self.L_f.shape == (3, n) and self.L_b.shape == (3, n)
        assert self.L_u.shape == (3, n) and self.MP.shape == (n,)
        assert self.MO.shape == (n,) and self.MG.shape == (n,)

    @property
    def num_layers(self) -> int:
        return len(self.layer_names)

    # Prefix sums (index k => layers 1..k inclusive) used all over the
    # scheduler; computed lazily and cached.
    def prefix(self) -> Dict[str, np.ndarray]:
        if not hasattr(self, "_prefix"):
            z = np.zeros((3, 1))
            zl = np.zeros(1)
            self._prefix = {
                "F": np.concatenate([z, np.cumsum(self.L_f, axis=1)], axis=1),
                "Bk": np.concatenate([z, np.cumsum(self.L_b, axis=1)], axis=1),
                "U": np.concatenate([z, np.cumsum(self.L_u, axis=1)], axis=1),
                "MP": np.concatenate([zl, np.cumsum(self.MP)]),
            }
        return self._prefix


@dataclasses.dataclass
class Network:
    """Bandwidths (bytes/s). ``bw_de``: device↔edge; ``bw_ec``: edge↔cloud."""
    bw_de: float
    bw_ec: float

    def bw(self, a: str, b: str) -> float:
        if a == b:
            return np.inf
        pair = frozenset((a, b))
        if pair == frozenset(("device", "edge")):
            return self.bw_de
        if pair == frozenset(("edge", "cloud")):
            return self.bw_ec
        # device <-> cloud: store-and-forward through the edge.
        return 1.0 / (1.0 / self.bw_de + 1.0 / self.bw_ec)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A full HierTrain scheduling decision (mapping + cuts + batch split)."""
    worker_o: str
    worker_s: str
    worker_l: str
    m_s: int
    m_l: int
    b_o: int
    b_s: int
    b_l: int

    @property
    def batch(self) -> int:
        return self.b_o + self.b_s + self.b_l

    def role_of(self, worker: str) -> Optional[str]:
        for role, w in (("o", self.worker_o), ("s", self.worker_s),
                        ("l", self.worker_l)):
            if w == worker:
                return role
        return None

    def describe(self) -> str:
        return (f"o={self.worker_o}(b={self.b_o}) "
                f"s={self.worker_s}(m={self.m_s},b={self.b_s}) "
                f"l={self.worker_l}(m={self.m_l},b={self.b_l})")


@dataclasses.dataclass
class Breakdown:
    """Per-phase latencies of one training iteration — Eq. (12) terms."""
    t_f1: float
    t_b1: float
    t_f2: float
    t_b2: float
    t_f3: float
    t_b3: float
    t_update: float
    # Diagnostics (not part of T_total; already contained in the above):
    comm_input: float = 0.0
    comm_activation: float = 0.0
    comm_weightgrad: float = 0.0

    @property
    def total(self) -> float:
        return (self.t_f1 + self.t_b1 + self.t_f2 + self.t_b2 +
                self.t_f3 + self.t_b3 + self.t_update)


def bw_matrix(net: Network) -> np.ndarray:
    """``[3, 3]`` pairwise bandwidth table over :data:`WORKERS` (diagonal is
    ``inf``: a worker talking to itself is free)."""
    return np.array([[net.bw(a, b) for b in WORKERS] for a in WORKERS],
                    np.float64)


def _t_total_batch(profile: HierProfile, net: Network,
                   o_idx: np.ndarray, s_idx: np.ndarray, l_idx: np.ndarray,
                   ms: np.ndarray, ml: np.ndarray, b: np.ndarray,
                   origin: str = "device") -> np.ndarray:
    """Vectorized :func:`_t_total` over K candidate schedules.

    Parameters
    ----------
    o_idx, s_idx, l_idx : ``[K]`` int — :data:`WIDX` indices of the workers
        holding TASK O / S / L.
    ms, ml : ``[K]`` int — cut points (``0 <= ms <= ml <= N``).
    b : ``[K, 3]`` — integer batch split ``(b_o, b_s, b_l)``.
    origin : worker the training data starts on.

    Returns ``[K]`` exact ``T_total`` values.  Every arithmetic expression
    mirrors the scalar :func:`t_total` term-for-term (same operation
    order), so a lane equals the scalar evaluation of the same schedule
    bit-for-bit — the batched scheduler's argmin agrees with the
    reference scheduler's sequential min.
    """
    N = profile.num_layers
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    bwm = bw_matrix(net)
    oi = WIDX[origin]
    Q = profile.sample_bytes
    bo = np.asarray(b[:, 0], np.float64)
    bs = np.asarray(b[:, 1], np.float64)
    bl = np.asarray(b[:, 2], np.float64)

    bw_os = bwm[o_idx, s_idx]
    bw_ol = bwm[o_idx, l_idx]

    # --- communication pieces -------------------------------------------
    def t_in(w_idx: np.ndarray, bb: np.ndarray) -> np.ndarray:
        return np.where((bb == 0) | (w_idx == oi), 0.0,
                        bb * Q / bwm[oi, w_idx])

    t_in_o, t_in_s, t_in_l = t_in(o_idx, bo), t_in(s_idx, bs), t_in(l_idx, bl)
    mo_s = profile.MO[np.maximum(ms, 1) - 1]   # MO_{m_s} (junk at ms == 0)
    mo_l = profile.MO[np.maximum(ml, 1) - 1]
    mg_s = profile.MG[np.maximum(ms, 1) - 1]   # backward wire bytes
    mg_l = profile.MG[np.maximum(ml, 1) - 1]
    t_s_out = np.where((ms > 0) & (bs > 0), bs * mo_s / bw_os, 0.0)
    t_l_out = np.where((ml > 0) & (bl > 0), bl * mo_l / bw_ol, 0.0)
    t_s_gout = np.where((ms > 0) & (bs > 0), bs * mg_s / bw_os, 0.0)
    t_l_gout = np.where((ml > 0) & (bl > 0), bl * mg_l / bw_ol, 0.0)

    # --- Eq. (5)/(6): layers 1..m_s on all three workers ----------------
    t_f1 = np.maximum(np.maximum(t_in_o + bo * F[o_idx, ms],
                                 t_in_s + bs * F[s_idx, ms] + t_s_out),
                      t_in_l + bl * F[l_idx, ms])
    t_b1 = np.maximum(np.maximum(bo * Bk[o_idx, ms],
                                 bs * Bk[s_idx, ms] + t_s_gout),
                      bl * Bk[l_idx, ms])

    # --- Eq. (7)/(8): layers m_s+1..m_l ---------------------------------
    t_f2 = np.maximum((bo + bs) * (F[o_idx, ml] - F[o_idx, ms]),
                      bl * (F[l_idx, ml] - F[l_idx, ms]) + t_l_out)
    t_b2 = np.maximum((bo + bs) * (Bk[o_idx, ml] - Bk[o_idx, ms]),
                      bl * (Bk[l_idx, ml] - Bk[l_idx, ms]) + t_l_gout)

    # --- Eq. (9)/(10): layers m_l+1..N with the full batch --------------
    B = bo + bs + bl
    t_f3 = B * (F[o_idx, N] - F[o_idx, ml])
    t_b3 = B * (Bk[o_idx, N] - Bk[o_idx, ml])

    # --- Eq. (11): weight update ----------------------------------------
    t_upd_o = U[o_idx, N]
    t_upd_s = np.where(bs > 0, U[s_idx, ms], 0.0)
    t_upd_l = np.where(bl > 0, U[l_idx, ml], 0.0)
    t_wg_s = np.where(bs > 0, 2.0 * MPc[ms] / bw_os, 0.0)
    t_wg_l = np.where(bl > 0, 2.0 * MPc[ml] / bw_ol, 0.0)
    t_update = np.maximum(np.maximum(t_upd_o, t_upd_s), t_upd_l) + \
        np.maximum(t_wg_s, t_wg_l)

    return t_f1 + t_b1 + t_f2 + t_b2 + t_f3 + t_b3 + t_update


# ---------------------------------------------------------------------------
# M-device generalization (DESIGN.md §6).
#
# Topology: M heterogeneous devices, each with its own uplink to one edge
# server; the edge uplinks to one cloud.  Training data lives on the devices
# (device-resident tasks read local samples for free; edge/cloud-resident
# tasks ingest their sub-batch uploaded evenly, in parallel, from all M
# devices).  One worker holds TASK O (full model), one holds TASK L (layers
# 1..m_l); every remaining worker holds a TASK-S instance with its own cut
# m_s[i] <= m_l.  With M = 1 this is exactly the paper's three-worker model
# (same six role mappings, same Eq. 12 — bit-for-bit; the equivalence suite
# asserts it).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiProfile:
    """Profiling-stage output for the M-device star topology.

    Same per-layer quantities as :class:`HierProfile` (including the
    optional backward wire bytes ``MG``, defaulting to ``MO``), but with
    one row per worker in ``worker_names`` order: ``M`` device rows first,
    then ``"edge"``, then ``"cloud"`` (so ``L_f`` is ``[M+2, N]``).
    """
    layer_names: Tuple[str, ...]
    worker_names: Tuple[str, ...]
    L_f: np.ndarray
    L_b: np.ndarray
    L_u: np.ndarray
    MP: np.ndarray
    MO: np.ndarray
    sample_bytes: float
    MG: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.L_f = np.asarray(self.L_f, np.float64)
        self.L_b = np.asarray(self.L_b, np.float64)
        self.L_u = np.asarray(self.L_u, np.float64)
        self.MP = np.asarray(self.MP, np.float64)
        self.MO = np.asarray(self.MO, np.float64)
        self.MG = self.MO if self.MG is None \
            else np.asarray(self.MG, np.float64)
        n, w = self.num_layers, self.num_workers
        if len(set(self.worker_names)) != w:
            dupes = sorted({x for x in self.worker_names
                            if self.worker_names.count(x) > 1})
            raise ValueError(f"duplicate worker names in fleet: {dupes}")
        self._check_names()
        assert self.L_f.shape == (w, n) and self.L_b.shape == (w, n)
        assert self.L_u.shape == (w, n) and self.MP.shape == (n,)
        assert self.MO.shape == (n,) and self.MG.shape == (n,)

    def _check_names(self) -> None:
        assert self.num_workers >= 3 and \
            self.worker_names[-2:] == ("edge", "cloud")

    @property
    def num_layers(self) -> int:
        return len(self.layer_names)

    @property
    def num_workers(self) -> int:
        return len(self.worker_names)

    @property
    def num_devices(self) -> int:
        return self.num_workers - 2

    @property
    def num_streams(self) -> int:
        """How many TASK-S streams a schedule on this profile carries:
        every worker that is neither ``worker_o`` nor ``worker_l``.  On a
        star this equals ``num_devices``; on a tree it is ``M + E - 1``
        (idle edges still hold a — possibly empty — stream slot)."""
        return self.num_workers - 2

    @property
    def device_names(self) -> Tuple[str, ...]:
        return self.worker_names[:-2]

    @property
    def widx(self) -> Dict[str, int]:
        return {w: i for i, w in enumerate(self.worker_names)}

    def prefix(self) -> Dict[str, np.ndarray]:
        if not hasattr(self, "_prefix"):
            z = np.zeros((self.num_workers, 1))
            zl = np.zeros(1)
            self._prefix = {
                "F": np.concatenate([z, np.cumsum(self.L_f, axis=1)], axis=1),
                "Bk": np.concatenate([z, np.cumsum(self.L_b, axis=1)],
                                     axis=1),
                "U": np.concatenate([z, np.cumsum(self.L_u, axis=1)], axis=1),
                "MP": np.concatenate([zl, np.cumsum(self.MP)]),
            }
        return self._prefix

    @classmethod
    def from_hier(cls, profile: HierProfile,
                  device_scales: Sequence[float] = (1.0,)) -> "MultiProfile":
        """Lift a 3-worker profile to M devices.

        ``device_scales[i]`` is device *i*'s slowdown relative to the
        profiled device row (1.0 = identical, 2.0 = half speed).  With a
        single scale of 1.0 the result is the numerically identical M=1
        profile (``x * 1.0`` is exact).
        """
        scales = np.asarray(tuple(device_scales), np.float64)
        assert scales.ndim == 1 and scales.size >= 1 and (scales > 0).all()
        m = scales.size
        names = (("device",) if m == 1 else
                 tuple(f"device_{i}" for i in range(m))) + ("edge", "cloud")

        def lift(a: np.ndarray) -> np.ndarray:
            return np.concatenate([a[0][None, :] * scales[:, None], a[1:]],
                                  axis=0)

        return cls(layer_names=profile.layer_names, worker_names=names,
                   L_f=lift(profile.L_f), L_b=lift(profile.L_b),
                   L_u=lift(profile.L_u), MP=profile.MP, MO=profile.MO,
                   sample_bytes=profile.sample_bytes, MG=profile.MG)

    def three_worker(self) -> HierProfile:
        """The exact 3-worker profile (requires ``M == 1``)."""
        assert self.num_devices == 1, "only an M=1 profile reduces"
        return HierProfile(layer_names=self.layer_names, L_f=self.L_f,
                           L_b=self.L_b, L_u=self.L_u, MP=self.MP,
                           MO=self.MO, sample_bytes=self.sample_bytes,
                           MG=self.MG)

    # ---- membership edits (elastic fleets, DESIGN.md §10) ---------------
    # All return NEW profiles (rows are copied, the per-layer columns are
    # shared); the prefix cache is never inherited, so downstream costs
    # always see the edited membership.

    def device_index(self, name: str) -> int:
        """Index of device ``name`` (raises on edge/cloud or unknown)."""
        if name not in self.device_names:
            raise ValueError(f"{name!r} is not a device of this fleet "
                             f"(devices: {self.device_names})")
        return self.widx[name]

    def drop_device(self, name: str) -> "MultiProfile":
        """Membership edit: remove device ``name`` (a leave or crash).

        The surviving rows are byte-identical to the original profile's,
        so every cost of the edited fleet equals a fresh fleet built from
        the survivors bit-for-bit."""
        i = self.device_index(name)
        if self.num_devices < 2:
            raise ValueError("cannot drop the last device of the fleet")
        keep = [j for j in range(self.num_workers) if j != i]
        return MultiProfile(
            layer_names=self.layer_names,
            worker_names=tuple(self.worker_names[j] for j in keep),
            L_f=self.L_f[keep].copy(), L_b=self.L_b[keep].copy(),
            L_u=self.L_u[keep].copy(), MP=self.MP, MO=self.MO,
            sample_bytes=self.sample_bytes, MG=self.MG)

    def add_device(self, name: str, L_f_row, L_b_row,
                   L_u_row) -> "MultiProfile":
        """Membership edit: append device ``name`` after the existing
        devices with the given per-layer second rows (seeded from the
        joiner's :class:`~repro_torch.core.profiler.WorkerSpec` tier by
        :func:`repro_torch.core.churn.apply_event`; the online EMA refines it
        from the first straggler report onward)."""
        if name in self.worker_names:
            raise ValueError(f"worker {name!r} already in the fleet")
        m = self.num_devices

        def ins(a: np.ndarray, row) -> np.ndarray:
            row = np.asarray(row, np.float64).reshape(1, -1)
            assert row.shape[1] == self.num_layers
            return np.concatenate([a[:m], row, a[m:]], axis=0)

        return MultiProfile(
            layer_names=self.layer_names,
            worker_names=self.worker_names[:m] + (name,) +
            self.worker_names[m:],
            L_f=ins(self.L_f, L_f_row), L_b=ins(self.L_b, L_b_row),
            L_u=ins(self.L_u, L_u_row), MP=self.MP, MO=self.MO,
            sample_bytes=self.sample_bytes, MG=self.MG)


@dataclasses.dataclass
class TreeProfile(MultiProfile):
    """Profiling-stage output for the two-level tree topology
    (DESIGN.md §12): ``M`` device rows, then ``n_edges`` edge rows, then
    one ``"cloud"`` row.

    The single edge is named ``"edge"`` at ``E = 1`` — the exact star
    naming, which is what makes E=1 tree DES traces (whose pipe names
    embed worker names) bit-identical to the star's — and
    ``edge_0..edge_{E-1}`` otherwise.  ``cloud_speedup`` records the
    data-parallel speedup baked into the cloud row by
    :meth:`from_multi` (a ``cloud_speedup``-way sharded cloud tier runs
    its segment that much faster); at the default 1.0 the row is
    bit-identical to the star's.
    """
    n_edges: int = 1
    cloud_speedup: float = 1.0

    def _check_names(self) -> None:
        assert self.n_edges >= 1 and \
            self.num_workers >= self.n_edges + 2, "need >= 1 device"
        assert self.worker_names[-1] == "cloud"
        want = ("edge",) if self.n_edges == 1 else \
            tuple(f"edge_{i}" for i in range(self.n_edges))
        assert self.worker_names[-1 - self.n_edges:-1] == want, \
            f"edge rows must be named {want}"

    @property
    def num_devices(self) -> int:
        return self.num_workers - self.n_edges - 1

    @property
    def device_names(self) -> Tuple[str, ...]:
        return self.worker_names[:self.num_devices]

    @property
    def edge_names(self) -> Tuple[str, ...]:
        return self.worker_names[self.num_devices:-1]

    @classmethod
    def from_multi(cls, profile: MultiProfile, n_edges: int = 1,
                   edge_scales: Optional[Sequence[float]] = None,
                   cloud_speedup: float = 1.0) -> "TreeProfile":
        """Lift a star profile to ``n_edges`` edge servers.

        ``edge_scales[e]`` is edge ``e``'s slowdown relative to the star's
        edge row; the cloud row is divided by ``cloud_speedup``.  With one
        edge at scale 1.0 and speedup 1.0 every row is numerically
        identical to the star profile (``x * 1.0`` and ``x / 1.0`` are
        exact), so the E=1 tree is the bit-exact star."""
        scales = np.ones(n_edges) if edge_scales is None else \
            np.asarray(tuple(edge_scales), np.float64)
        assert scales.shape == (n_edges,) and (scales > 0).all()
        assert cloud_speedup > 0
        m = profile.num_devices
        names = profile.worker_names[:m] + \
            (("edge",) if n_edges == 1 else
             tuple(f"edge_{i}" for i in range(n_edges))) + ("cloud",)

        def lift(a: np.ndarray) -> np.ndarray:
            return np.concatenate(
                [a[:m], a[m][None, :] * scales[:, None],
                 a[m + 1][None, :] / cloud_speedup], axis=0)

        return cls(layer_names=profile.layer_names, worker_names=names,
                   L_f=lift(profile.L_f), L_b=lift(profile.L_b),
                   L_u=lift(profile.L_u), MP=profile.MP, MO=profile.MO,
                   sample_bytes=profile.sample_bytes, MG=profile.MG,
                   n_edges=n_edges, cloud_speedup=cloud_speedup)

    def to_multi(self) -> MultiProfile:
        """The exact star profile (requires ``E == 1``)."""
        assert self.n_edges == 1, "only an E=1 profile reduces to a star"
        return MultiProfile(
            layer_names=self.layer_names, worker_names=self.worker_names,
            L_f=self.L_f, L_b=self.L_b, L_u=self.L_u, MP=self.MP,
            MO=self.MO, sample_bytes=self.sample_bytes, MG=self.MG)


@dataclasses.dataclass
class StarNetwork:
    """Star topology: per-device uplinks ``bw_de[i]`` (device_i↔edge) and one
    backhaul ``bw_ec`` (edge↔cloud), all in bytes/s.  Paths without a direct
    link (device↔cloud, device↔device) are the series composition of their
    hops through the edge, matching :meth:`Network.bw`."""
    bw_de: np.ndarray
    bw_ec: float

    def __post_init__(self) -> None:
        self.bw_de = np.atleast_1d(np.asarray(self.bw_de, np.float64))
        assert (self.bw_de > 0).all() and self.bw_ec > 0

    @property
    def num_devices(self) -> int:
        return int(self.bw_de.size)

    # Tree-compat view (a star is the one-edge tree): generic code paths
    # read ``num_edges``/``edge_of``/``backhaul`` off either network type.
    @property
    def num_edges(self) -> int:
        return 1

    @property
    def edge_of(self) -> Tuple[int, ...]:
        return (0,) * self.num_devices

    @property
    def backhaul(self) -> np.ndarray:
        return np.array([self.bw_ec], np.float64)

    @classmethod
    def from_network(cls, net: Network, num_devices: int = 1
                     ) -> "StarNetwork":
        return cls(bw_de=np.full(num_devices, net.bw_de), bw_ec=net.bw_ec)

    def three_worker(self) -> Network:
        assert self.num_devices == 1
        return Network(bw_de=float(self.bw_de[0]), bw_ec=self.bw_ec)

    def bw_matrix(self) -> np.ndarray:
        """``[M+2, M+2]`` pairwise bandwidths in worker order (devices...,
        edge, cloud); diagonal ``inf``.  ``[i, j]`` for two devices is the
        relayed series path through the edge."""
        m = self.num_devices
        w = m + 2
        bwm = np.full((w, w), np.inf)
        de, ec = self.bw_de, self.bw_ec
        bwm[:m, m] = bwm[m, :m] = de                     # device_i <-> edge
        bwm[m, m + 1] = bwm[m + 1, m] = ec               # edge <-> cloud
        dc = 1.0 / (1.0 / de + 1.0 / ec)                 # relayed, Fig. 1(c)
        bwm[:m, m + 1] = bwm[m + 1, :m] = dc
        dd = 1.0 / (1.0 / de[:, None] + 1.0 / de[None, :])
        dd[np.diag_indices(m)] = np.inf
        bwm[:m, :m] = dd
        return bwm

    # ---- membership edits (elastic fleets, DESIGN.md §10) ---------------

    def drop_device(self, i: int) -> "StarNetwork":
        """Remove device ``i``'s uplink (paired with
        :meth:`MultiProfile.drop_device`)."""
        if not 0 <= i < self.num_devices:
            raise ValueError(f"no device {i} in a {self.num_devices}-device "
                             "star")
        if self.num_devices < 2:
            raise ValueError("cannot drop the last device of the fleet")
        return StarNetwork(bw_de=np.delete(self.bw_de, i), bw_ec=self.bw_ec)

    def add_device(self, bw: float) -> "StarNetwork":
        """Append a device uplink of ``bw`` bytes/s."""
        return StarNetwork(bw_de=np.concatenate([self.bw_de, [bw]]),
                           bw_ec=self.bw_ec)

    def scale_uplink(self, i: int, factor: float) -> "StarNetwork":
        """Multiply device ``i``'s uplink by ``factor`` (a
        :class:`~repro_torch.core.churn.LinkDegrade`; ``factor > 1`` heals)."""
        if not 0 <= i < self.num_devices:
            raise ValueError(f"no device {i} in a {self.num_devices}-device "
                             "star")
        if factor <= 0:
            raise ValueError("uplink scale factor must be positive")
        bw = self.bw_de.copy()
        bw[i] *= factor
        return StarNetwork(bw_de=bw, bw_ec=self.bw_ec)

    def upload_bw(self) -> np.ndarray:
        """``[M+2]`` effective ingest bandwidth for a worker receiving its
        sub-batch uploaded *evenly in parallel* from all M devices: the
        slowest uplink carries ``1/M`` of the bytes, so the edge ingests at
        ``M * min(bw_de)`` and the cloud at the series composition of that
        with the backhaul.  Devices read local samples (``inf``)."""
        m = self.num_devices
        up = np.full(m + 2, np.inf)
        radio = m * self.bw_de.min()
        up[m] = radio
        up[m + 1] = 1.0 / (1.0 / radio + 1.0 / self.bw_ec)
        return up


@dataclasses.dataclass
class TreeNetwork:
    """Two-level tree: device ``i`` reaches its edge ``edge_of[i]`` over
    radio ``bw_de[i]``; edge ``e`` reaches the cloud over its own backhaul
    ``bw_ec[e]`` (all bytes/s).  Paths without a direct link are series
    compositions of their hops — device↔cloud through the device's edge,
    edge↔edge and device↔foreign-edge through the cloud.  With one edge
    every pairwise path reduces to the :class:`StarNetwork` expression
    bit-for-bit (series terms enter as exact ``+ 0.0``)."""
    bw_de: np.ndarray
    bw_ec: np.ndarray
    edge_of: Tuple[int, ...] = (0,)

    def __post_init__(self) -> None:
        self.bw_de = np.atleast_1d(np.asarray(self.bw_de, np.float64))
        self.bw_ec = np.atleast_1d(np.asarray(self.bw_ec, np.float64))
        self.edge_of = tuple(int(e) for e in self.edge_of)
        assert (self.bw_de > 0).all() and (self.bw_ec > 0).all()
        assert len(self.edge_of) == self.num_devices
        counts = np.bincount(self.edge_of, minlength=self.num_edges)
        assert counts.size == self.num_edges and (counts > 0).all(), \
            "every edge needs at least one device"

    @property
    def num_devices(self) -> int:
        return int(self.bw_de.size)

    @property
    def num_edges(self) -> int:
        return int(self.bw_ec.size)

    @property
    def backhaul(self) -> np.ndarray:
        return self.bw_ec

    @classmethod
    def from_star(cls, net: StarNetwork) -> "TreeNetwork":
        return cls(bw_de=net.bw_de, bw_ec=np.array([net.bw_ec]),
                   edge_of=(0,) * net.num_devices)

    def to_star(self) -> StarNetwork:
        assert self.num_edges == 1, "only an E=1 tree reduces to a star"
        return StarNetwork(bw_de=self.bw_de, bw_ec=float(self.bw_ec[0]))

    def bw_matrix(self) -> np.ndarray:
        """``[M+E+1, M+E+1]`` pairwise bandwidths in worker order
        (devices..., edges..., cloud); diagonal ``inf``."""
        m, e = self.num_devices, self.num_edges
        w = m + e + 1
        eo = np.asarray(self.edge_of)
        de, ec = self.bw_de, self.bw_ec
        inv_bh = 1.0 / ec[eo]                        # [M] own-backhaul term
        bwm = np.full((w, w), np.inf)
        # device_i <-> edge_k: direct radio to its own edge, relayed via
        # its own backhaul + the foreign edge's backhaul otherwise.
        same = eo[:, None] == np.arange(e)[None, :]          # [M, E]
        d_edge = np.where(
            same, de[:, None],
            1.0 / (1.0 / de[:, None] + inv_bh[:, None] + 1.0 / ec[None, :]))
        bwm[:m, m:m + e] = d_edge
        bwm[m:m + e, :m] = d_edge.T
        # edge_k <-> cloud: its own backhaul.
        bwm[m:m + e, m + e] = bwm[m + e, m:m + e] = ec
        # device_i <-> cloud: radio in series with its edge's backhaul —
        # the star's relayed Fig. 1(c) path, per-edge.
        dc = 1.0 / (1.0 / de + inv_bh)
        bwm[:m, m + e] = bwm[m + e, :m] = dc
        # device_i <-> device_j: series through the shared edge, plus both
        # backhauls when the devices sit under different edges.  The
        # same-edge term adds an exact 0.0, so at E=1 this is the star's
        # ``dd`` expression bit-for-bit.
        cross = 1.0 / de[:, None] + 1.0 / de[None, :] + np.where(
            eo[:, None] == eo[None, :], 0.0,
            inv_bh[:, None] + inv_bh[None, :])
        dd = 1.0 / cross
        dd[np.diag_indices(m)] = np.inf
        bwm[:m, :m] = dd
        # edge_a <-> edge_b: series through the cloud.
        ee = 1.0 / (1.0 / ec[:, None] + 1.0 / ec[None, :])
        ee[np.diag_indices(e)] = np.inf
        bwm[m:m + e, m:m + e] = ee
        return bwm

    def upload_bw(self) -> np.ndarray:
        """``[M+E+1]`` effective ingest bandwidth under the even-upload
        model (every device ships ``b/M`` samples to the destination).
        An all-local edge ingests at ``M * min_j path(j, dst)`` — the
        star expression bit-for-bit, so E=1 always takes that branch.
        Chunks that cross a backhaul serialize per shaped pipe (matching
        the simulator's input classes): the cloud composes the bottleneck
        radio aggregate with the bottleneck per-edge uplink share
        ``min_e bw_ec[e] / (M_e / M)``; a foreign-edge destination adds
        the worst foreign uplink (``M_e`` chunks over ``bw_ec[e]``) and
        its own downlink (``M - M_k`` foreign chunks over ``bw_ec[k]``)
        in series with the radio stage."""
        m, e = self.num_devices, self.num_edges
        up = np.full(m + e + 1, np.inf)
        bwm = self.bw_matrix()
        counts = np.bincount(self.edge_of, minlength=e)
        for k in range(e):
            if counts[k] == m:            # all devices local (always at E=1)
                up[m + k] = m * bwm[:m, m + k].min()
            else:
                inv = (1.0 / self.bw_de.min() +
                       max(counts[e2] / self.bw_ec[e2]
                           for e2 in range(e) if e2 != k) +
                       (m - counts[k]) / self.bw_ec[k])
                up[m + k] = m / inv
        radio = m * self.bw_de.min()
        bh = (self.bw_ec / (counts / m)).min()
        up[m + e] = 1.0 / (1.0 / radio + 1.0 / bh)
        return up


@dataclasses.dataclass(frozen=True)
class MultiSchedule:
    """An M-device HierTrain scheduling decision.

    ``s_workers[i]`` runs a TASK-S instance over layers ``1..m_s[i]`` on its
    ``b_s[i]`` samples; ``worker_o``/``worker_l`` are as in :class:`Schedule`.
    ``len(s_workers) == M`` always (the non-o, non-l workers)."""
    worker_o: str
    worker_l: str
    s_workers: Tuple[str, ...]
    m_s: Tuple[int, ...]
    m_l: int
    b_o: int
    b_s: Tuple[int, ...]
    b_l: int

    @property
    def batch(self) -> int:
        return self.b_o + sum(self.b_s) + self.b_l

    def describe(self) -> str:
        s = " ".join(f"s={w}(m={m},b={b})" for w, m, b in
                     zip(self.s_workers, self.m_s, self.b_s))
        return (f"o={self.worker_o}(b={self.b_o}) {s} "
                f"l={self.worker_l}(m={self.m_l},b={self.b_l})")

    @classmethod
    def from_schedule(cls, sched: Schedule) -> "MultiSchedule":
        return cls(worker_o=sched.worker_o, worker_l=sched.worker_l,
                   s_workers=(sched.worker_s,), m_s=(sched.m_s,),
                   m_l=sched.m_l, b_o=sched.b_o, b_s=(sched.b_s,),
                   b_l=sched.b_l)

    def to_schedule(self) -> Schedule:
        assert len(self.s_workers) == 1, "only an M=1 schedule reduces"
        return Schedule(worker_o=self.worker_o, worker_s=self.s_workers[0],
                        worker_l=self.worker_l, m_s=self.m_s[0],
                        m_l=self.m_l, b_o=self.b_o, b_s=self.b_s[0],
                        b_l=self.b_l)


def _validate_multi(profile: MultiProfile, sched: MultiSchedule) -> None:
    N = profile.num_layers
    S = profile.num_streams
    assert len(sched.s_workers) == len(sched.m_s) == len(sched.b_s) == S
    assert 0 <= sched.m_l <= N
    for m_i, b_i in zip(sched.m_s, sched.b_s):
        assert 0 <= m_i <= sched.m_l, "need 0 <= m_s[i] <= m_l <= N"
        if m_i == 0:
            assert b_i == 0, "m_s[i] = 0 forces b_s[i] = 0"
    if sched.m_l == 0:
        assert sched.b_l == 0, "m_l = 0 forces b_l = 0"
    widx = profile.widx
    seen = {sched.worker_o, sched.worker_l, *sched.s_workers}
    assert len(seen) == S + 2 and all(w in widx for w in seen), \
        "schedule must name every worker exactly once"


def _t_total_multi(profile: MultiProfile, net: StarNetwork,
                   sched: MultiSchedule) -> Breakdown:
    """Exact generalized Eq. (12) for an integer M-device schedule.

    Phase structure (DESIGN.md §6): phase 1 runs every TASK-S front-end in
    parallel up to its own cut; worker_o's catch-up of stream *i* from
    ``m_s[i]`` to ``max_i m_s[i]`` is charged to phase 2 alongside the
    common ``max_i m_s[i] .. m_l`` block.  With ``M = 1`` every term reduces
    to the three-worker expression bit-for-bit.
    """
    _validate_multi(profile, sched)
    N = profile.num_layers
    D = profile.num_devices       # data holders (locality), not streams
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    widx = profile.widx
    o, l = widx[sched.worker_o], widx[sched.worker_l]
    s = [widx[w] for w in sched.s_workers]
    ml = sched.m_l
    bo, bl = sched.b_o, sched.b_l
    bs = sched.b_s
    msmax = max(sched.m_s)
    bwm = net.bw_matrix()
    up = net.upload_bw()
    Q = profile.sample_bytes

    def t_in(w: int, b: int) -> float:
        if b == 0 or w < D:          # device-resident: local data
            return 0.0
        return b * Q / up[w]

    t_in_o, t_in_l = t_in(o, bo), t_in(l, bl)
    t_in_s = [t_in(si, bi) for si, bi in zip(s, bs)]
    t_s_out = [bi * profile.MO[mi - 1] / bwm[o, si]
               if (mi > 0 and bi > 0) else 0.0
               for si, mi, bi in zip(s, sched.m_s, bs)]
    t_l_out = bl * profile.MO[ml - 1] / bwm[o, l] \
        if (ml > 0 and bl > 0) else 0.0
    t_s_gout = [bi * profile.MG[mi - 1] / bwm[o, si]
                if (mi > 0 and bi > 0) else 0.0
                for si, mi, bi in zip(s, sched.m_s, bs)]
    t_l_gout = bl * profile.MG[ml - 1] / bwm[o, l] \
        if (ml > 0 and bl > 0) else 0.0

    # --- phase 1: every front-end in parallel up to its own cut ----------
    t_f1 = max(t_in_o + bo * F[o, msmax],
               *[ti + bi * F[si, mi] + to for ti, si, mi, bi, to in
                 zip(t_in_s, s, sched.m_s, bs, t_s_out)],
               t_in_l + bl * F[l, msmax])
    t_b1 = max(bo * Bk[o, msmax],
               *[bi * Bk[si, mi] + to for si, mi, bi, to in
                 zip(s, sched.m_s, bs, t_s_gout)],
               bl * Bk[l, msmax])

    # --- phase 2: worker_o catches every stream up, then the common block -
    bs_sum = sum(bs)
    catch_f = sum(bi * (F[o, msmax] - F[o, mi])
                  for mi, bi in zip(sched.m_s, bs))
    catch_b = sum(bi * (Bk[o, msmax] - Bk[o, mi])
                  for mi, bi in zip(sched.m_s, bs))
    t_f2 = max((bo + bs_sum) * (F[o, ml] - F[o, msmax]) + catch_f,
               bl * (F[l, ml] - F[l, msmax]) + t_l_out)
    t_b2 = max((bo + bs_sum) * (Bk[o, ml] - Bk[o, msmax]) + catch_b,
               bl * (Bk[l, ml] - Bk[l, msmax]) + t_l_gout)

    # --- phase 3 + weight update (as in the three-worker model) ----------
    B = bo + bs_sum + bl
    t_f3 = B * (F[o, N] - F[o, ml])
    t_b3 = B * (Bk[o, N] - Bk[o, ml])
    t_upd_o = U[o, N]
    t_upd_s = [U[si, mi] if bi > 0 else 0.0
               for si, mi, bi in zip(s, sched.m_s, bs)]
    t_upd_l = U[l, ml] if bl > 0 else 0.0
    t_wg_s = [2.0 * MPc[mi] / bwm[o, si] if bi > 0 else 0.0
              for si, mi, bi in zip(s, sched.m_s, bs)]
    t_wg_l = 2.0 * MPc[ml] / bwm[o, l] if bl > 0 else 0.0
    t_update = max(t_upd_o, *t_upd_s, t_upd_l) + max(*t_wg_s, t_wg_l)

    return Breakdown(
        t_f1=t_f1, t_b1=t_b1, t_f2=t_f2, t_b2=t_b2, t_f3=t_f3, t_b3=t_b3,
        t_update=t_update,
        comm_input=t_in_o + sum(t_in_s) + t_in_l,
        comm_activation=(sum(t_s_out) + t_l_out) +
                        (sum(t_s_gout) + t_l_gout),
        comm_weightgrad=max(*t_wg_s, t_wg_l),
    )


def _t_total_multi_batch(profile: MultiProfile, net: StarNetwork,
                         o_idx: np.ndarray, s_idx: np.ndarray,
                         l_idx: np.ndarray, ms: np.ndarray, ml: np.ndarray,
                         b: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_t_total_multi` over K candidate schedules.

    ``o_idx, l_idx, ml``: ``[K]``; ``s_idx, ms``: ``[K, S]``;
    ``b``: ``[K, S+2]`` split ``(b_o, b_s[0..S-1], b_l)`` where ``S`` is
    ``profile.num_streams`` (``M`` on a star, ``M + E - 1`` on a tree).
    Every arithmetic expression mirrors the scalar evaluation
    term-for-term, and with ``M = 1`` also mirrors :func:`t_total_batch`
    — a lane is bit-identical to both.
    """
    N = profile.num_layers
    D = profile.num_devices       # data holders (locality), not streams
    S = profile.num_streams
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    bwm = net.bw_matrix()
    up = net.upload_bw()
    Q = profile.sample_bytes
    bo = np.asarray(b[:, 0], np.float64)
    bs = np.asarray(b[:, 1:1 + S], np.float64)
    bl = np.asarray(b[:, 1 + S], np.float64)
    o2 = o_idx[:, None]
    msmax = ms.max(axis=1)

    bw_os = bwm[o_idx[:, None], s_idx]        # [K, S]
    bw_ol = bwm[o_idx, l_idx]

    def t_in(w_idx: np.ndarray, bb: np.ndarray) -> np.ndarray:
        return np.where((bb == 0) | (w_idx < D), 0.0, bb * Q / up[w_idx])

    t_in_o, t_in_s, t_in_l = t_in(o_idx, bo), t_in(s_idx, bs), t_in(l_idx, bl)
    mo_s = profile.MO[np.maximum(ms, 1) - 1]
    mo_l = profile.MO[np.maximum(ml, 1) - 1]
    mg_s = profile.MG[np.maximum(ms, 1) - 1]
    mg_l = profile.MG[np.maximum(ml, 1) - 1]
    t_s_out = np.where((ms > 0) & (bs > 0), bs * mo_s / bw_os, 0.0)
    t_l_out = np.where((ml > 0) & (bl > 0), bl * mo_l / bw_ol, 0.0)
    t_s_gout = np.where((ms > 0) & (bs > 0), bs * mg_s / bw_os, 0.0)
    t_l_gout = np.where((ml > 0) & (bl > 0), bl * mg_l / bw_ol, 0.0)

    # --- phase 1 ---------------------------------------------------------
    t_f1 = np.maximum(np.maximum(t_in_o + bo * F[o_idx, msmax],
                                 (t_in_s + bs * F[s_idx, ms] +
                                  t_s_out).max(axis=1)),
                      t_in_l + bl * F[l_idx, msmax])
    t_b1 = np.maximum(np.maximum(bo * Bk[o_idx, msmax],
                                 (bs * Bk[s_idx, ms] +
                                  t_s_gout).max(axis=1)),
                      bl * Bk[l_idx, msmax])

    # --- phase 2 (catch-up + common block) -------------------------------
    bs_sum = bs.sum(axis=1)
    catch_f = (bs * (F[o2, msmax[:, None]] - F[o2, ms])).sum(axis=1)
    catch_b = (bs * (Bk[o2, msmax[:, None]] - Bk[o2, ms])).sum(axis=1)
    t_f2 = np.maximum(
        (bo + bs_sum) * (F[o_idx, ml] - F[o_idx, msmax]) + catch_f,
        bl * (F[l_idx, ml] - F[l_idx, msmax]) + t_l_out)
    t_b2 = np.maximum(
        (bo + bs_sum) * (Bk[o_idx, ml] - Bk[o_idx, msmax]) + catch_b,
        bl * (Bk[l_idx, ml] - Bk[l_idx, msmax]) + t_l_gout)

    # --- phase 3 + update ------------------------------------------------
    B = bo + bs_sum + bl
    t_f3 = B * (F[o_idx, N] - F[o_idx, ml])
    t_b3 = B * (Bk[o_idx, N] - Bk[o_idx, ml])
    t_upd_o = U[o_idx, N]
    t_upd_s = np.where(bs > 0, U[s_idx, ms], 0.0).max(axis=1)
    t_upd_l = np.where(bl > 0, U[l_idx, ml], 0.0)
    t_wg_s = np.where(bs > 0, 2.0 * MPc[ms] / bw_os, 0.0).max(axis=1)
    t_wg_l = np.where(bl > 0, 2.0 * MPc[ml] / bw_ol, 0.0)
    t_update = np.maximum(np.maximum(t_upd_o, t_upd_s), t_upd_l) + \
        np.maximum(t_wg_s, t_wg_l)

    return t_f1 + t_b1 + t_f2 + t_b2 + t_f3 + t_b3 + t_update


def t_input(profile: HierProfile, net: Network, worker: str, b: int,
            origin: str = "device") -> float:
    """``T_{j,input}``: latency for worker *j* to receive its ``b`` samples."""
    if b == 0 or worker == origin:
        return 0.0
    return b * profile.sample_bytes / net.bw(origin, worker)


def _t_total(profile: HierProfile, net: Network, sched: Schedule,
             origin: str = "device") -> Breakdown:
    """Exact Eq. (12) evaluation for an (integer) schedule.

    This is the canonical *three-worker* evaluation — the correctness
    oracle the M=1 equivalence suite compares the star model against,
    and the only path that supports ``origin != "device"`` or
    degenerate schedules that repeat a worker across roles (the
    all-on-one baselines)."""
    N = profile.num_layers
    assert 0 <= sched.m_s <= sched.m_l <= N, "need 0 <= m_s <= m_l <= N"
    if sched.m_s == 0:
        assert sched.b_s == 0, "m_s = 0 forces b_s = 0 (constraint (14))"
    if sched.m_l == 0:
        assert sched.b_l == 0, "m_l = 0 forces b_l = 0 (constraint (15))"
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    o, s, l = WIDX[sched.worker_o], WIDX[sched.worker_s], WIDX[sched.worker_l]
    ms, ml = sched.m_s, sched.m_l
    bo, bs, bl = sched.b_o, sched.b_s, sched.b_l

    bw_os = net.bw(sched.worker_o, sched.worker_s)
    bw_ol = net.bw(sched.worker_o, sched.worker_l)

    # --- communication pieces -------------------------------------------
    t_in_o = t_input(profile, net, sched.worker_o, bo, origin)
    t_in_s = t_input(profile, net, sched.worker_s, bs, origin)
    t_in_l = t_input(profile, net, sched.worker_l, bl, origin)
    # T_{s,output} = b_s * MO_{m_s} / B_{o,s}  (§IV-C); T_{s,grad} uses the
    # backward wire bytes MG_{m_s} (== MO by default, LM profiles differ).
    t_s_out = bs * profile.MO[ms - 1] / bw_os if (ms > 0 and bs > 0) else 0.0
    t_l_out = bl * profile.MO[ml - 1] / bw_ol if (ml > 0 and bl > 0) else 0.0
    t_s_gout = bs * profile.MG[ms - 1] / bw_os if (ms > 0 and bs > 0) else 0.0
    t_l_gout = bl * profile.MG[ml - 1] / bw_ol if (ml > 0 and bl > 0) else 0.0

    # --- Eq. (5)/(6): layers 1..m_s on all three workers ----------------
    t_f1 = max(t_in_o + bo * F[o, ms],
               t_in_s + bs * F[s, ms] + t_s_out,
               t_in_l + bl * F[l, ms])
    t_b1 = max(bo * Bk[o, ms],
               bs * Bk[s, ms] + t_s_gout,
               bl * Bk[l, ms])

    # --- Eq. (7)/(8): layers m_s+1..m_l on worker_o (b_o+b_s) & worker_l -
    t_f2 = max((bo + bs) * (F[o, ml] - F[o, ms]),
               bl * (F[l, ml] - F[l, ms]) + t_l_out)
    t_b2 = max((bo + bs) * (Bk[o, ml] - Bk[o, ms]),
               bl * (Bk[l, ml] - Bk[l, ms]) + t_l_gout)

    # --- Eq. (9)/(10): layers m_l+1..N on worker_o with the full batch ---
    B = bo + bs + bl
    t_f3 = B * (F[o, N] - F[o, ml])
    t_b3 = B * (Bk[o, N] - Bk[o, ml])

    # --- Eq. (11): weight update -----------------------------------------
    # worker_o updates all N layers (TASK O is the full model); worker_s
    # updates 1..m_s; worker_l updates 1..m_l.  Gradient exchange covers the
    # *shared* (frontend) layers only: 2 * sum MP_i (push grads + pull avg).
    t_upd_o = U[o, N]
    t_upd_s = U[s, ms] if bs > 0 else 0.0
    t_upd_l = U[l, ml] if bl > 0 else 0.0
    t_wg_s = 2.0 * MPc[ms] / bw_os if bs > 0 else 0.0
    t_wg_l = 2.0 * MPc[ml] / bw_ol if bl > 0 else 0.0
    t_update = max(t_upd_o, t_upd_s, t_upd_l) + max(t_wg_s, t_wg_l)

    return Breakdown(
        t_f1=t_f1, t_b1=t_b1, t_f2=t_f2, t_b2=t_b2, t_f3=t_f3, t_b3=t_b3,
        t_update=t_update,
        comm_input=t_in_o + t_in_s + t_in_l,
        comm_activation=(t_s_out + t_l_out) + (t_s_gout + t_l_gout),
        comm_weightgrad=max(t_wg_s, t_wg_l),
    )


# ---------------------------------------------------------------------------
# Tree topology entry points (DESIGN.md §12).  The generalized multi
# evaluators above are stream-generic — a tree schedule carries
# S = M + E - 1 TASK-S streams and the per-edge structure lives in
# TreeProfile/TreeNetwork — so these are thin, *supported* (not
# deprecated) wrappers with tree-typed signatures.
# ---------------------------------------------------------------------------


def t_total_tree(profile: TreeProfile, net: TreeNetwork,
                 sched: MultiSchedule) -> Breakdown:
    """Exact generalized Eq. (12) for an integer tree schedule.  At
    ``E = 1`` every term is the star's :func:`_t_total_multi` expression
    bit-for-bit (the equivalence suite asserts it)."""
    return _t_total_multi(profile, net, sched)


def t_total_tree_batch(profile: TreeProfile, net: TreeNetwork,
                       o_idx: np.ndarray, s_idx: np.ndarray,
                       l_idx: np.ndarray, ms: np.ndarray, ml: np.ndarray,
                       b: np.ndarray) -> np.ndarray:
    """Vectorized :func:`t_total_tree` over K candidate lanes
    (``s_idx``/``ms``: ``[K, S]``, ``b``: ``[K, S+2]``)."""
    return _t_total_multi_batch(profile, net, o_idx, s_idx, l_idx, ms, ml,
                                b)

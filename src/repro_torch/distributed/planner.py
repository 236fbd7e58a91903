"""Static load balancing: replaces the paper's Spark shuffle.

liquidSVM's Spark layer dynamically shuffles work to workers.  Here balance
is decided on the host, before launch: cells are padded to a uniform size
and greedily bin-packed (longest processing time first) into per-device
slots (``pack_cells``); ``group_rows`` packs routed rows into padded
per-slot blocks.

Serving keeps a static-shape discipline: each engine step is
one batched launch over a padded (n_slots, m_pad, d) block, but per-cell
request counts are whatever traffic happened to arrive.  :func:`plan_wave`
is the per-step plan: pick a padded row count (bucketed so repeated steps
reuse the same launch shapes), split hot cells into multiple launch slots
instead of padding every cell to the hottest one, and order slots
largest-first (LPT) so a sharded engine inherits the balance for free.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cells.builder import CellPlan


def _round_up(v: int, mult: int) -> int:
    return -(-max(int(v), 1) // mult) * mult


@dataclasses.dataclass
class RowGroups:
    """Argsort-grouped rows for padded per-slot scatter/gather:
    ``packed[g.slot, g.pos] = x[g.rows]`` packs, ``out[g.rows] =
    dec[g.slot, g.pos]`` unpacks."""
    rows: np.ndarray     # (m,) int64
    slot: np.ndarray     # (m,) int64
    pos: np.ndarray      # (m,) int64
    counts: np.ndarray   # (n_slots,) int64

    @property
    def m_max(self) -> int:
        return max(int(self.counts.max()), 1) if self.counts.size else 1


def group_rows(slot_of: np.ndarray, n_slots: int) -> RowGroups:
    """Group row ids by destination slot (stable — ascending within slot)."""
    slot_of = np.asarray(slot_of, np.int64)
    counts = np.bincount(slot_of, minlength=n_slots).astype(np.int64)
    order = np.argsort(slot_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_sorted = slot_of[order]
    pos = np.arange(slot_of.shape[0], dtype=np.int64) - starts[slot_sorted]
    return RowGroups(rows=order, slot=slot_sorted, pos=pos, counts=counts)


@dataclasses.dataclass
class PackedCells:
    order: np.ndarray          # (n_slots,) cell id per slot, -1 = empty slot
    slot_of_cell: np.ndarray   # (n_cells,)
    n_devices: int
    slots_per_device: int

    @property
    def n_slots(self) -> int:
        return self.order.shape[0]


def pack_cells(plan: CellPlan, n_devices: int) -> PackedCells:
    """LPT bin packing of cells onto devices; returns a slot ordering whose
    leading axis splits evenly over the devices."""
    sizes = plan.mask.sum(1)
    n_cells = plan.n_cells
    slots_per_device = int(np.ceil(n_cells / n_devices))
    loads = np.zeros(n_devices)
    counts = np.zeros(n_devices, np.int32)
    assign = np.full((n_devices, slots_per_device), -1, np.int64)
    for cid in np.argsort(-sizes):  # biggest first
        free = np.where(counts < slots_per_device)[0]
        dev = free[np.argmin(loads[free])]
        assign[dev, counts[dev]] = cid
        loads[dev] += sizes[cid]
        counts[dev] += 1
    order = assign.reshape(-1)
    slot_of = np.full(n_cells, -1, np.int64)
    for s, cid in enumerate(order):
        if cid >= 0:
            slot_of[cid] = s
    return PackedCells(order=order, slot_of_cell=slot_of,
                       n_devices=n_devices, slots_per_device=slots_per_device)


@dataclasses.dataclass
class WavePlan:
    """One serving step's static launch layout.

    slot_cell: (n_slots,) cell id per launch slot, -1 = padding slot
    slot_off:  (n_slots,) offset into that cell's pending queue
    slot_take: (n_slots,) pending rows consumed by this slot (<= m_pad)
    m_pad:     padded rows per slot (every slot is (m_pad, d) in the launch)
    """
    slot_cell: np.ndarray
    slot_off: np.ndarray
    slot_take: np.ndarray
    m_pad: int

    @property
    def n_slots(self) -> int:
        return self.slot_cell.shape[0]

    @property
    def n_requests(self) -> int:
        return int(self.slot_take.sum())

    @property
    def pad_fraction(self) -> float:
        """Fraction of launched rows that are padding (lower = better)."""
        total = self.n_slots * self.m_pad
        return 1.0 - self.n_requests / max(total, 1)


def plan_wave(counts: np.ndarray, m_pad: int | None = None,
              row_bucket: int = 8, slot_bucket: int = 4) -> WavePlan:
    """Padding/bin-packing plan for one engine step.

    ``counts`` (n_cells,) pending requests per cell.  The padded row count
    defaults to the 75th-percentile active-cell load (bucketed to
    ``row_bucket``): cold cells pad a little, hot cells are CHUNKED into
    several launch slots — so one viral cell cannot inflate the whole
    step's padded shape.  Slot count is bucketed to ``slot_bucket`` and
    slots are LPT-ordered; both paddings keep the set of launch shapes
    small across steps.
    """
    counts = np.asarray(counts, np.int64)
    active = np.where(counts > 0)[0]
    if active.size == 0:
        return WavePlan(slot_cell=np.full(0, -1, np.int64),
                        slot_off=np.zeros(0, np.int64),
                        slot_take=np.zeros(0, np.int64),
                        m_pad=row_bucket)
    if m_pad is None:
        m_pad = _round_up(int(np.percentile(counts[active], 75)), row_bucket)
    cells, offs, takes = [], [], []
    for cid in active:
        left, off = int(counts[cid]), 0
        while left > 0:
            take = min(left, m_pad)
            cells.append(cid)
            offs.append(off)
            takes.append(take)
            off += take
            left -= take
    order = np.argsort(-np.asarray(takes), kind="stable")   # LPT
    n_slots = _round_up(len(cells), slot_bucket)
    slot_cell = np.full(n_slots, -1, np.int64)
    slot_off = np.zeros(n_slots, np.int64)
    slot_take = np.zeros(n_slots, np.int64)
    for s, o in enumerate(order):
        slot_cell[s] = cells[o]
        slot_off[s] = offs[o]
        slot_take[s] = takes[o]
    return WavePlan(slot_cell=slot_cell, slot_off=slot_off,
                    slot_take=slot_take, m_pad=int(m_pad))

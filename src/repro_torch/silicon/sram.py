"""First-order CACTI-style SRAM subarray energy/area model.

CACTI (and the Accelergy wrapper the sweep cache mirrors) decomposes an
SRAM macro into cell matrix + peripheral circuitry and prices each
access as wire/device capacitance switched at the supply rail.  This
module is the same decomposition in closed form, small enough to audit:

* **Geometry.**  A :class:`SRAMSpec` names the technology node, the
  subarray shape (``wordlines`` rows x ``bitlines`` columns), the array
  count and the port count.  A 6T cell occupies ``cell_f2`` F^2 (F = the
  feature size); the cell aspect ratio fixes wordline/bitline wire
  lengths, which dominate the switched capacitance.

* **Energy.**  One wordline activation charges the wordline wire plus
  one access-transistor gate per column (``E = C * Vdd^2``).  A read
  additionally develops a small-signal swing (``v_swing_frac * Vdd``) on
  every bitline pair and fires one sense amp per column; a write drives
  full-rail swing on the written pairs.  An in-SRAM *compute* cycle is
  the Neural-Cache sequence — two wordline activations (both operands),
  the read swing, and the per-column peripheral logic (single-bit ALU +
  carry latch).

* **Area.**  Cell matrix plus CACTI-style peripheral overhead expressed
  in row/column equivalents (sense amps, write drivers and precharge as
  extra rows; row decoder and wordline drivers as extra columns), divided
  by an inter-array routing efficiency for the macro total.

* **Scaling.**  Linear dimensions scale with F, device/wire capacitance
  per unit length approximately with F^0.5, and Vdd weakly (DVS floors);
  so energy and area both shrink monotonically with the node — the
  monotonicity contract ``tests/test_silicon.py`` asserts.

Absolute constants below are documented 7 nm anchors, but the consumers
(:mod:`repro_torch.silicon.params`, :mod:`repro_torch.silicon.area`) use this model
**ratiometrically**: only the *relative* scaling between two geometries
ever reaches an :class:`~repro_torch.core.cost.EnergyParams` or an area table,
and the default Table IV geometry is pinned to the repo's calibrated
constants (docs/SILICON.md, "Calibration contract").
"""
from __future__ import annotations

import dataclasses
import functools
import math

#: Reference node (nm) all constants below are anchored at.
REFERENCE_NODE_NM = 7.0

# -- 7 nm anchor constants ---------------------------------------------------
_VDD_7NM = 0.75               # V, nominal supply
_CELL_F2 = 157.0              # 6T high-density cell size in F^2
_CELL_ASPECT = 2.0            # cell width : height
_C_WIRE_FF_PER_UM = 0.20      # wire capacitance per um (M2-level)
_C_GATE_FF = 0.025            # access-transistor gate cap per cell on a WL
_C_DRAIN_FF = 0.020           # pass-gate drain cap per cell on a BL
_E_SENSE_PJ = 0.0020          # one sense-amp fire
_E_LOGIC_PJ = 0.0040          # per-column single-bit ALU + carry latch
_E_WIRE_PJ_PER_MM_BIT = 0.08  # H-tree data wire energy per bit per mm
_V_SWING_FRAC = 0.10          # read develop swing as a fraction of Vdd
_ROW_OVERHEAD = 18.0          # sense amps/write drivers/precharge, in rows
_COL_OVERHEAD = 14.0          # row decoder + WL drivers, in columns
_ARRAY_EFFICIENCY = 0.85      # macro area efficiency (inter-array routing)
_LEAK_NW_PER_CELL = 0.0015    # per-cell leakage power at 7 nm
_PORT_AREA_FACTOR = 0.35      # extra cell area per additional port
_PORT_CAP_FACTOR = 0.25       # extra BL/WL loading per additional port


@dataclasses.dataclass(frozen=True)
class SRAMSpec:
    """One SRAM macro: ``num_arrays`` subarrays of ``wordlines`` rows x
    ``bitlines`` columns in a ``tech_nm`` process."""

    tech_nm: float = 7.0
    num_arrays: int = 32
    bitlines: int = 256        # columns = SIMD lanes per array
    wordlines: int = 256       # rows = register-file bits per lane
    ports: int = 1

    def __post_init__(self) -> None:
        if self.tech_nm <= 0 or self.num_arrays <= 0 or self.ports <= 0 \
                or self.bitlines <= 0 or self.wordlines <= 0:
            raise ValueError(f"non-physical SRAMSpec: {self}")


@dataclasses.dataclass(frozen=True)
class SRAMEstimate:
    """Model output: per-access energies (pJ), leakage (mW), area (mm^2).

    ``read_pj_per_byte`` is the macro-level transfer cost — one access
    amortized over the bits it delivers plus the H-tree wire energy to
    the macro edge — which is what the L2->TMU ``e_l2_byte`` constant
    scales with.
    """

    wl_activate_pj: float      # one wordline activation in one subarray
    read_access_pj: float      # one full-row read (all bitlines)
    write_access_pj: float     # one full-row write
    compute_cycle_pj: float    # one in-SRAM compute cycle per subarray
    read_pj_per_byte: float    # macro transfer cost per byte
    leakage_mw: float          # whole-macro standby leakage
    subarray_area_mm2: float   # one subarray incl. its peripherals
    total_area_mm2: float      # whole macro incl. routing inefficiency


def _vdd(tech_nm: float) -> float:
    """Supply voltage: scales weakly with the node (DVS floors keep Vdd
    far from linear shrink)."""
    return _VDD_7NM * (tech_nm / REFERENCE_NODE_NM) ** 0.3


@functools.lru_cache(maxsize=4096)
def estimate(spec: SRAMSpec) -> SRAMEstimate:
    """Evaluate the analytic model for one :class:`SRAMSpec`.

    Pure and memoized — two equal specs return the *same* estimate
    object, which is what makes the ratio calibration in
    :mod:`repro_torch.silicon.params` exact (``x / x == 1.0``).
    """
    s = spec.tech_nm / REFERENCE_NODE_NM    # linear feature scale
    vdd = _vdd(spec.tech_nm)
    port_cap = 1.0 + _PORT_CAP_FACTOR * (spec.ports - 1)
    port_area = 1.0 + _PORT_AREA_FACTOR * (spec.ports - 1)

    # cell geometry (um)
    f_um = spec.tech_nm * 1e-3
    cell_area_um2 = _CELL_F2 * f_um * f_um * port_area
    cell_w = math.sqrt(cell_area_um2 * _CELL_ASPECT)
    cell_h = cell_area_um2 / cell_w
    wl_len_um = spec.bitlines * cell_w
    bl_len_um = spec.wordlines * cell_h

    # switched capacitance (fF); device caps scale ~F, wire caps ~sqrt(F)
    c_wire = _C_WIRE_FF_PER_UM * math.sqrt(s)
    c_wl = (spec.bitlines * _C_GATE_FF * s + wl_len_um * c_wire) * port_cap
    c_bl = (spec.wordlines * _C_DRAIN_FF * s + bl_len_um * c_wire) * port_cap

    # energies (fF * V^2 = fJ; /1e3 -> pJ)
    wl_activate = c_wl * vdd * vdd * 1e-3
    bl_read_swing = spec.bitlines * c_bl * vdd * (_V_SWING_FRAC * vdd) * 1e-3
    bl_write_swing = 0.5 * spec.bitlines * c_bl * vdd * vdd * 1e-3
    sense = spec.bitlines * _E_SENSE_PJ * s * s
    logic = spec.bitlines * _E_LOGIC_PJ * s * s
    read_access = wl_activate + bl_read_swing + sense
    write_access = wl_activate + bl_write_swing
    # Neural-Cache compute cycle: both operand wordlines + sense + ALU
    compute_cycle = 2.0 * wl_activate + bl_read_swing + sense + logic

    # area (mm^2)
    subarray_area = ((spec.wordlines + _ROW_OVERHEAD) * cell_h *
                     (spec.bitlines + _COL_OVERHEAD) * cell_w) * 1e-6
    total_area = spec.num_arrays * subarray_area / _ARRAY_EFFICIENCY

    # macro transfer cost: one row read amortized over its bytes, plus
    # the H-tree hop to the macro edge (~sqrt(area) of wire per bit)
    htree_mm = math.sqrt(total_area)
    read_per_byte = (read_access / (spec.bitlines / 8.0) +
                     8.0 * htree_mm * _E_WIRE_PJ_PER_MM_BIT * s)

    cells = spec.num_arrays * spec.wordlines * spec.bitlines
    leakage_mw = cells * _LEAK_NW_PER_CELL * s * s * vdd / _VDD_7NM * 1e-6

    return SRAMEstimate(
        wl_activate_pj=wl_activate,
        read_access_pj=read_access,
        write_access_pj=write_access,
        compute_cycle_pj=compute_cycle,
        read_pj_per_byte=read_per_byte,
        leakage_mw=leakage_mw,
        subarray_area_mm2=subarray_area,
        total_area_mm2=total_area,
    )

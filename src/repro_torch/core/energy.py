"""Power & area model — Table I / Table IV constants (7 nm node).

Per unit router-PE pair (Table IV):
  IMC PE (RRAM-CIM)  120 uW   0.1442 mm^2
  Scratchpad          42 uW   0.0130 mm^2
  Router              97 uW   0.0250 mm^2
  TSVs                 -      0.0020 mm^2
  total              259 uW   0.1842 mm^2
  Softmax CU         5.31 uW  0.0410 mm^2 (1024 per tile)

A compute tile (chiplet) is a 32x32 IPCN -> 1024 router-PE pairs,
189.6 mm^2.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MacroPower:  # watts
    imc_pe: float = 120e-6
    scratchpad: float = 42e-6
    router: float = 97e-6
    softmax: float = 5.31e-6

    @property
    def router_pe_pair(self) -> float:
        return self.imc_pe + self.scratchpad + self.router   # 259 uW


@dataclass(frozen=True)
class MacroArea:  # mm^2
    imc_pe: float = 0.1442
    scratchpad: float = 0.013
    router: float = 0.025
    tsv: float = 0.002
    softmax: float = 0.041

    @property
    def router_pe_pair(self) -> float:
        return self.imc_pe + self.scratchpad + self.router + self.tsv


@dataclass(frozen=True)
class TileSpec:
    ipcn_dim: int = 32                  # Table I
    softmax_units: int = 1024
    frequency_hz: float = 1e9
    bit_width: int = 64
    power: MacroPower = field(default_factory=MacroPower)
    area: MacroArea = field(default_factory=MacroArea)

    @property
    def n_pairs(self) -> int:
        return self.ipcn_dim * self.ipcn_dim

    @property
    def tile_power_active(self) -> float:
        """Fully-active chiplet power."""
        return (self.n_pairs * self.power.router_pe_pair
                + self.softmax_units * self.power.softmax)

    @property
    def tile_power_sleep(self) -> float:
        """CCPG sleep: only scratchpads stay on for KV retention
        (paper §II-E); RRAM weights are non-volatile — zero retention power.
        """
        return self.n_pairs * self.power.scratchpad

    @property
    def tile_area_mm2(self) -> float:
        return (self.n_pairs * self.area.router_pe_pair
                + self.softmax_units * self.area.softmax)

    @property
    def weights_capacity(self) -> int:
        """Weights storable per chiplet: 1024 PE x 256x256 cells."""
        return self.n_pairs * 256 * 256


# Energy per bit for data movement (paper §I + refs [11])
E_ELECTRICAL_C2C = 3.0e-12      # J/bit
E_OPTICAL_C2C = 0.4e-12         # J/bit — silicon photonic MRM link [15]
E_DRAM_ACCESS = 30e-12          # J/bit off-chip
E_ONCHIP_HOP = 0.05e-12         # J/bit per mesh hop


def table_iv() -> dict:
    p, a = MacroPower(), MacroArea()
    return {
        "IMC PE": {"power_uW": p.imc_pe * 1e6, "area_mm2": a.imc_pe},
        "Scratchpad": {"power_uW": p.scratchpad * 1e6, "area_mm2": a.scratchpad},
        "Router": {"power_uW": p.router * 1e6, "area_mm2": a.router},
        "TSVs": {"power_uW": 0.0, "area_mm2": a.tsv},
        "Total (IPCN-PE)": {"power_uW": p.router_pe_pair * 1e6,
                            "area_mm2": a.router_pe_pair},
        "Softmax": {"power_uW": p.softmax * 1e6, "area_mm2": a.softmax},
    }

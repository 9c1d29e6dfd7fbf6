"""The paper's own experimental configuration (FMMU, Woo & Min 2017):
the port's own copy of ``repro/configs/fmmu_paper.py``.

Table 1 (V1/V2 2-bit 3D NAND), §5.1 experimental setup: 16GB SSD,
16-channel × 8-way, 15% over-provisioning, two planes per chip,
NVMe over PCIe 3.0 x16 (15.76 GB/s), 1,088KB map-cache RAM
(DFTL: all CMT; CDFTL/FMMU: 64KB CMT + 1,024KB CTP), second-chance
replacement everywhere, 400MHz ARM Cortex-R4 / 400MHz FMMU clock.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NandTiming:
    """Table 1 — per-die timing/geometry of 2-bit 3D NAND."""
    name: str
    page_data_bytes: int
    page_oob_bytes: int
    pages_per_block: int
    read_us: float
    program_us: float
    erase_us: float
    bus_mbps: float          # per-channel data transfer rate (MB/s)
    bus_op_overhead_us: float = 0.2   # cmd/addr cycles + DMA setup per op

    @property
    def block_bytes(self) -> int:
        return self.page_data_bytes * self.pages_per_block

    def transfer_us(self, nbytes: int) -> float:
        return nbytes / self.bus_mbps  # MB/s == bytes/us


# V1: 8K page, 3M+336K block -> 384 pages/block; V2: 16K page, 4M block -> 256
NAND_V1 = NandTiming("V1", 8192, 896, 384, 49.0, 600.0, 4000.0, 533.0)
NAND_V2 = NandTiming("V2", 16384, 1536, 256, 35.0, 390.0, 4000.0, 667.0)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    nand: NandTiming = NAND_V2
    channels: int = 16
    ways: int = 8
    planes: int = 2
    capacity_gb: int = 16
    op_ratio: float = 0.15           # over-provisioning share of raw capacity
    sector_bytes: int = 4096         # host logical sector (4KB)
    host_bw_gbps: float = 15.76      # NVMe over PCIe 3.0 x16
    outstanding: int = 512
    # --- map cache unit (bytes of RAM) ---
    map_ram_bytes: int = 1088 * 1024
    cmt_ram_bytes: int = 64 * 1024   # CDFTL / FMMU first level
    ctp_ram_bytes: int = 1024 * 1024
    cmt_block_entries: int = 8       # consecutive DLPN->DPPN entries per CMT block
    assoc: int = 4                   # set associativity (both levels)
    map_entry_bytes: int = 4         # DPPN width
    # --- FMMU engine ---
    fmmu_clock_mhz: float = 400.0
    cpu_clock_mhz: float = 400.0     # ARM Cortex-R4
    dtl_entries: int = 128
    flush_low_watermark: float = 0.10   # of blocks non-dirty
    flush_high_watermark: float = 0.25

    @property
    def entries_per_tp(self) -> int:
        """DLPN->DPPN entries per translation page."""
        return self.nand.page_data_bytes // self.map_entry_bytes

    @property
    def n_chips(self) -> int:
        return self.channels * self.ways

    @property
    def logical_pages(self) -> int:
        usable = int(self.capacity_gb * (1 << 30))
        return usable // self.nand.page_data_bytes

    @property
    def physical_pages(self) -> int:
        raw = int(self.capacity_gb * (1 << 30) / (1.0 - self.op_ratio))
        return raw // self.nand.page_data_bytes

    @property
    def host_transfer_us_4k(self) -> float:
        return 4096 / (self.host_bw_gbps * 1000.0)  # GB/s == bytes/ns -> us


PAPER_SSD = SSDConfig()

"""PICNIC core, the port's own copy of what ``PicnicSimulator`` needs:
``energy``, ``interconnect``, ``partition``, ``noc``, ``mapping``,
``scheduling``, ``ccpg``, ``timeline`` and ``simulator`` of
``repro.core``, verbatim (plain Python and numpy), so that the port
imports nothing of the JAX package.  The ISA, program and codegen modules
are not copied; the SCU's PWL table lives in ``kernels/pwl.py``.

Layers:
  noc                — 32x32 router mesh, spanning-tree collectives
  partition/mapping  — crossbar tiling + Fig-6 spatial placement
  scheduling         — layer->chiplet allocation, flash-attention schedule,
                       cyclic KV striping, cycle model
  energy/ccpg        — Table I/IV power-area model, cluster power gating
  interconnect       — photonic vs electrical C2C, measured traffic
  timeline           — TimelineIR: typed event stream + span-integrated
                       energy, with a chrome://tracing exporter
  simulator          — end-to-end tokens/s, W, tokens/J (Tables II/III)
"""
from .noc import Mesh2D, MeshConfig
from .partition import PEArraySpec, partition_matrix, attention_grids, ffn_grids
from .mapping import map_layer, fits_one_chiplet
from .scheduling import allocate_chiplets, llm_layers, CycleModel
from .energy import TileSpec, MacroPower, MacroArea, table_iv
from .ccpg import CCPGModel, CLUSTER_SIZE
from .interconnect import (OPTICAL, ELECTRICAL, MeasuredTraffic,
                           c2c_average_power, TrafficTrace)
from .timeline import (Timeline, ComputeSpan, C2CTransfer, ClusterWake,
                       ClusterSleep, EnergySample, TokenEmit, NodeFail,
                       NodeRecover, EVENT_CATEGORIES,
                       FAULT_EVENT_CATEGORIES, ALL_EVENT_CATEGORIES)
from .simulator import PicnicSimulator, comparison_table, PLATFORMS

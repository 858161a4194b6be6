"""Mesh-shape sweep of the collective wire bytes the PyTorch port issues.

The port's counterpart of ``examples/collective_sweep.py``.  For each
TP x SP mesh shape (and one PP mesh) this runs the port's sharded prefill
/ decode cells once on fake tensors over a fake world of 8 ranks
(``repro_torch.launch.collective_capture``), counts the per-collective
ring-model wire bytes of the collectives they issue, and feeds the decode
traffic into the port's PICNIC simulator as the measured photonic C2C
term, printed next to the default analytic estimate.  Smoke-sized configs
by default; pass --full for the real arch (paper-scale bytes).  Nothing
is allocated on any device, so it runs the same on any host.  Ends with
``OK``.

  PYTHONPATH=src python examples/collective_sweep_torch.py [arch] [--full]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import PicnicSimulator
    from repro_torch.launch.collective_capture import capture_cell, to_measured_traffic

    arch = next((a for a in argv if not a.startswith("-")), "llama3.2-1b")
    smoke = "--full" not in argv

    print(f"=== {arch} ({'smoke' if smoke else 'full'} config), seq 512 ===")
    captures = {}
    for mesh in ("1x8", "2x4", "4x2"):
        row = {}
        for mode in ("prefill", "decode"):
            rec = capture_cell(arch, mode=mode, seq_len=512,
                               batch=int(mesh.split("x")[0]), mesh=mesh,
                               variant="picnic", smoke=smoke)
            row[mode] = rec
            colls = {op: f"{d['wire_bytes']:.2e}B"
                     for op, d in sorted(rec["collectives"].items())}
            print(f"mesh {mesh} (data x model) {mode:7s} "
                  f"wire/chip={rec['wire_bytes_per_chip']:.3e}B  {colls}")
        captures[mesh] = row

    # GPipe cell: pod x data x model, batch 16: 8 microbatches x 2-way DP
    rec = capture_cell(arch, mode="train", seq_len=128, batch=16,
                       mesh="2x2x2", variant="pp", smoke=smoke)
    colls = {op: f"{d['wire_bytes']:.2e}B"
             for op, d in sorted(rec["collectives"].items())}
    print(f"mesh 2x2x2 (pod x data x model) pp-train "
          f"wire/chip={rec['wire_bytes_per_chip']:.3e}B  {colls}")

    # feed the 1x8 decode traffic into the photonic cost model
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    mt = to_measured_traffic(captures["1x8"]["prefill"],
                             captures["1x8"]["decode"])
    sim = PicnicSimulator()
    r_an = sim.run(cfg, 512, 512)
    r_me = sim.run(cfg, 512, 512, measured_c2c=mt)
    print(f"\nsimulator C2C term    analytic: {r_an.c2c_bytes_total:.3e}B "
          f"-> {1e3 * r_an.c2c_avg_power_W:.3f} mW")
    print(f"                      measured: {r_me.c2c_bytes_total:.3e}B "
          f"-> {1e3 * r_me.c2c_avg_power_W:.3f} mW "
          f"(source {r_me.c2c_source})")
    print("throughput unchanged:", r_an.throughput_tps == r_me.throughput_tps)
    assert r_an.throughput_tps == r_me.throughput_tps
    assert r_me.c2c_source.startswith("c10d:") and r_me.c2c_bytes_total > 0
    print("OK")


if __name__ == "__main__":
    main()

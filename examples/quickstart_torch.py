"""Quickstart on the PyTorch port: the five steps of ``examples/quickstart.py``
(the architectures; mixtral's smoke config, its init and forward; three
train steps; a prefill and 8 greedy decode steps; the PICNIC hardware
model, the port's ``PicnicSimulator``, on the paper's llama3-8b
1024/1024 with CCPG).  Steps 1-4 run on the card by default; ``--device
cpu`` runs the plain PyTorch path.  Step 5 is plain Python on the host.
Ends with ``OK``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import models
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.common import count_params, resolve_device

    device = resolve_device(args.device)
    print("assigned architectures:", ", ".join(list_archs()[:10]))

    # 1. pick an architecture (smoke = CPU-sized config of the same family)
    cfg = get_smoke_config("mixtral-8x7b")
    print(f"\nmodel: {cfg.name} ({cfg.family}), "
          f"{cfg.n_layers}L d={cfg.d_model} experts={cfg.moe.n_experts}, on {device}")

    # 2. init + forward
    params = models.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    print("params:", f"{count_params(params) / 1e6:.2f}M")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        logits, aux_loss, _ = models.forward(cfg, params, tokens)
    print("logits:", tuple(logits.shape), "router aux loss:", float(aux_loss))
    assert logits.shape == (2, 64, cfg.vocab_size) and bool(torch.isfinite(logits).all())

    # 3. a couple of train steps
    params, opt_state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    step = make_train_step(cfg)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    for i in range(3):
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        print(f"step {i}: loss {loss:.4f}")
        assert loss == loss and abs(loss) < float("inf")

    # 4. prefill + greedy decode
    with torch.no_grad():
        logits, _, cache = models.forward(cfg, params, tokens[:, :32], collect_cache=True,
                                          kv_max=64)
        tok = torch.argmax(logits[:, -1:], -1)
        out = [tok]
        for i in range(8):
            logits, cache = models.decode_step(cfg, params, tok, cache, 33 + i)
            tok = torch.argmax(logits, -1)
            out.append(tok)
    ids = torch.cat(out, 1)
    print("greedy continuation:", ids[0].tolist())
    assert ids.shape == (2, 9) and bool(((ids >= 0) & (ids < cfg.vocab_size)).all())

    # 5. the PICNIC hardware model on the paper's own benchmark
    from repro_torch.configs import get_config
    from repro_torch.core import PicnicSimulator
    sim = PicnicSimulator()
    r = sim.run(get_config("llama3-8b"), 1024, 1024, ccpg=True)
    print(f"\nPICNIC Llama-8B 1024/1024 + CCPG: {r.throughput_tps:.1f} tok/s, "
          f"{r.avg_power_W:.2f} W, {r.efficiency_tpj:.1f} tok/J "
          f"(paper: 309.8 tok/s, 5.6 W, 55.4 tok/J)")
    assert r.throughput_tps > 0 and r.avg_power_W > 0
    print("OK")


if __name__ == "__main__":
    main()

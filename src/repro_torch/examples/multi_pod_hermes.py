"""Level-B Hermes at LM scale: pod replicas + gated loss-weighted merges
(the reference's ``examples/multi_pod_hermes.py``).

Four pods train a small LM on disjoint shards; every lambda steps each
pod's eval loss feeds HermesGUP, and gate-opening pods merge into the global
model with reciprocal-loss weights (Algorithm 2's model-space form).  The
printout shows how rarely the gate opens (= how much cross-pod
communication Hermes saves) while the global loss still tracks the pods,
beside a single replica trained on every step.

    python -m repro_torch.examples.multi_pod_hermes [--device cpu]
"""
import argparse
import json

from repro_torch.config import HermesConfig, OptimizerConfig
from repro_torch.launch.train import _preset, train_hermes, train_single


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = _preset("lmtiny")
    opt = OptimizerConfig(name="adamw", lr=3e-3)

    print("== dense baseline (every-step sync semantics) ==")
    base = train_single(cfg, steps=120, batch=8, seq=64, opt_cfg=opt,
                        log_every=40, device=args.device)

    print("== Hermes: 4 pods, gated merges ==")
    out = train_hermes(cfg, steps=200, batch=8, seq=64, pods=4, opt_cfg=opt,
                       hcfg=HermesConfig(alpha=-1.6, beta=0.1, lam=8,
                                         eta=1.0),
                       log_every=50, device=args.device)

    print(json.dumps({
        "baseline_final_loss": round(base["final_loss"], 4),
        "hermes_global_loss": round(out["global_loss"], 4),
        "hermes_best_pod_loss": round(out["best_pod_loss"], 4),
        "merge_rounds": f"{out['merges']}/{out['rounds']}",
        "comm_fraction": round(out["comm_fraction"], 3),
    }, indent=2))


if __name__ == "__main__":
    main()

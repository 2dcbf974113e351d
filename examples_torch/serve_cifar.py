"""Train-then-serve on the PyTorch port: the whole NITRO-D integer
lifecycle on one CNN fleet (the port of ``examples/serve_cifar.py``).

    PYTHONPATH=src python examples_torch/serve_cifar.py            # on the card
    PYTHONPATH=src python examples_torch/serve_cifar.py --device cpu \
        --steps 4 --scale 0.0625                                   # plain PyTorch

1. trains a reduced VGG8B with the integer-only LES trainer on the
   CIFAR-shaped synthetic set (tiles32), freezing a mid-training snapshot
   on the way: two checkpoints of one architecture, the A/B pair (prod vs
   candidate);
2. exports both with ``save_frozen`` and a ``FLEET.json`` fleet manifest,
   then loads everything back through ``ModelRegistry.from_manifest``;
3. serves the test set through the continuous-batching ``FleetEngine``
   behind a 90/10 ``Router`` split from several concurrent client threads;
   the request id's hash decides each request's arm;
4. checks that every served prediction equals ``model.predict`` of the
   arm that answered it, and reports per-arm accuracy and stats;
5. hot-swaps the candidate arm to the final checkpoint under its stable
   model id and shows the swap taking effect on live traffic.
"""

import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_paper_config
from repro_torch.core import les, prng
from repro_torch.core import model as M
from repro_torch.data import synthetic
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.infer import (
    freeze,
    load_frozen,
    save_fleet_manifest,
    save_frozen,
)
from repro_torch.serving import (
    FleetEngine,
    ModelRegistry,
    Router,
    fleet_snapshot_delta,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scale", type=float, default=0.125)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--serve-batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- 1. integer-only training, snapshotting the A/B candidate --------
    ds = synthetic.make_image_dataset("tiles32", n_train=2048, n_test=256,
                                      seed=args.seed)
    cfg = get_paper_config("vgg8b", scale=args.scale,
                           input_shape=ds.input_shape)
    state = les.create_train_state(prng.PRNGKey(args.seed), cfg, device=device)
    snapshot_at = max(1, args.steps // 2)
    mid_state = state  # train_step returns a new state: snapshots stay put
    it = 0
    while it < args.steps:
        for x, y in synthetic.batches(ds.x_train, ds.y_train, args.batch,
                                      seed=it):
            if it >= args.steps:
                break
            state, metrics = les.train_step(
                state, cfg, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device), prng.PRNGKey(it))
            if it % 20 == 0:
                print(f"[train] step {it:4d} loss={int(metrics.loss)} "
                      f"correct={int(metrics.correct)}/{args.batch}")
            it += 1
            if it == snapshot_at:
                mid_state = state  # the "candidate" arm: half-trained
    print(f"[train] prod = step {args.steps}, candidate = step {snapshot_at}")

    # ---- 2. export both arms + fleet manifest, reload via the registry ---
    splits = {"split": {"prod": 0.9, "candidate": 0.1}}
    with tempfile.TemporaryDirectory() as fleet_dir:
        save_frozen(f"{fleet_dir}/prod", freeze(state, cfg))
        save_frozen(f"{fleet_dir}/candidate", freeze(mid_state, cfg))
        save_fleet_manifest(fleet_dir,
                            {"prod": "prod", "candidate": "candidate"},
                            splits=splits)
        registry = ModelRegistry.from_manifest(fleet_dir, device=device)
        fm_prod = load_frozen(f"{fleet_dir}/prod")
    print(f"[export] fleet {registry.ids()}: {len(fm_prod.layers)} layers, "
          f"{fm_prod.num_bytes()} weight bytes/arm")

    # ---- 3. A/B serve through the router, concurrent clients -------------
    router = Router(splits)
    images = list(ds.x_test)
    labels_true = ds.y_test
    predictions = np.full(len(images), -1, np.int64)
    arms = [router.resolve("split", f"req-{i}") for i in range(len(images))]

    with FleetEngine(registry, batch_size=args.serve_batch,
                     router=router) as engine:
        engine.classify(images[:1], model="prod")  # first launches off the clock
        engine.classify(images[:1], model="candidate")
        pre = engine.snapshot()

        def client(worker: int):
            for i in range(worker, len(images), args.clients):
                predictions[i] = engine.submit(
                    images[i], model="split", request_id=f"req-{i}",
                ).result(timeout=120).label

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        # delta against the post-warm-up snapshot: only the timed serving
        snapshot = fleet_snapshot_delta(pre, engine.snapshot())

        # ---- 4. per-arm parity + accuracy --------------------------------
        batch = torch.from_numpy(np.stack(images)).to(device)
        want = {
            "prod": M.predict(state.params, cfg, batch).cpu().numpy(),
            "candidate": M.predict(mid_state.params, cfg, batch).cpu().numpy(),
        }
        mismatches = sum(
            int(predictions[i] != want[arm][i])
            for i, arm in enumerate(arms)
        )
        if mismatches:
            raise SystemExit(f"{mismatches} fleet/model.predict prediction mismatches")
        fleet = snapshot["fleet"]
        print(f"[serve] {len(images)} requests from {args.clients} clients "
              f"in {wall:.3f}s ({len(images) / wall:.1f} req/s), "
              f"{fleet['batches']} batches, "
              f"fill {fleet['avg_batch_fill']:.2f}")
        for arm in ("prod", "candidate"):
            idx = [i for i, a in enumerate(arms) if a == arm]
            acc = float(np.mean(predictions[idx] == labels_true[idx]))
            print(f"[serve]   {arm}: {len(idx)} requests "
                  f"({len(idx) / len(images):.0%} of traffic), "
                  f"accuracy {acc:.4f}")
        print("[parity] every answer bit-identical to its arm's "
              "model.predict ✓")

        # ---- 5. hot-swap the candidate to the final checkpoint -----------
        entry = registry.swap("candidate", freeze(state, cfg))
        swapped = [engine.submit(img, model="candidate").result(timeout=120).label
                   for img in images[:32]]
        if not np.array_equal(swapped, want["prod"][:32]):
            raise SystemExit("after the swap the candidate does not answer as prod")
        print(f"[swap] candidate -> final checkpoint "
              f"(version {entry.version}); live traffic now matches prod ✓")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""chip_smoke.py's phases 16 and 17 (the multi-device layer over a mesh of
ranks) alone on the card, after phase 2's kernel cases.

    python3 scripts/chip_mesh_phase.py      # from the repository root

It builds the kernels, runs phase 2 (`kernel_phase`, `fleet_kernel_phase`:
every kernel against its plain version, timed, phase 17's shapes
included), fits on one rank from the same seeds what phases 16 and 17
hold the mesh fits to (phase 3's dense LR, sparse LR with phase 4's
plain-loss fit, KMeans, stream LR and stream KMeans, and phase 10's sparse
fleet), and runs `chip_smoke.mesh_phase` and `chip_smoke.mesh2d_phase` on
one gloo world, which print each fit and exit non-zero on a failed gate.
About four minutes on an H100."""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import cuda_build, losses
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.ops.optimizer import SGD

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cuda_build.load_all(("sparse_kernels", "probes", "designs"))
    sk.build()
    probes, designs = cs.load_probes(cuda_build), cs.load_designs(cuda_build, sk)
    cs.kernel_phase(sk, probes, designs, dev)
    cs.fleet_kernel_phase(sk, probes, designs, dev)
    cs.log(f"phase 2 in {time.perf_counter() - t_start:.1f} s")
    runs = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    X = torch.rand((cs.DENSE_ROWS, cs.DIM), generator=gen, device=dev)
    y = torch.randint(0, 2, (cs.DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
    w = torch.rand((cs.DENSE_ROWS,), generator=gen, device=dev)
    runs["dense lr"] = {"model": cs.estimator(logisticregression.LogisticRegression, "weight")
                        .fit(Table({"features": X, "label": y, "weight": w}))}
    del X, y, w
    s_idx, s_vals, s_y = cs.sparse_data(dev)
    runs["sparse lr"] = {
        "model": cs.estimator(logisticregression.LogisticRegression).fit(
            Table({"features": SparseBatch(cs.SPARSE_DIM, s_idx, s_vals), "label": s_y})),
        "plain_coefficient": SGD(max_iter=cs.MAX_ITER, learning_rate=cs.LEARNING_RATE,
                                 global_batch_size=cs.BATCH, tol=cs.TOL).optimize(
            np.zeros(cs.SPARSE_DIM), (s_idx, s_vals), s_y, None,
            losses.PLAIN_SPARSE_VARIANTS["binary_logistic"])[0]}
    from flink_ml_tpu_torch.fleet import FitFleet

    sparse_table = Table({"features": SparseBatch(cs.SPARSE_DIM, s_idx, s_vals), "label": s_y})
    fleet_models = {"sparse": FitFleet(cs.fleet_members(logisticregression.LogisticRegression))
                    .fit(sparse_table)}
    del s_idx, s_vals, s_y, sparse_table
    km_X = cs.kmeans_data(dev)
    runs["kmeans"] = {"model": cs.kmeans_estimator().fit(Table({"features": km_X}))}
    km_cols = {"features": km_X.cpu().numpy()}
    del km_X
    runs["stream kmeans"] = {"model": cs.kmeans_estimator().fit(
        cs.stream_of(km_cols, cs.KMEANS_ROWS, cs.KMEANS_CHUNK))}
    stream_cols = cs.stream_lr_data(cs.MAX_ITER * cs.BATCH)
    runs["stream lr"] = {"model": cs.estimator(logisticregression.LogisticRegression, "weight")
                         .fit(cs.stream_of(stream_cols, cs.MAX_ITER * cs.BATCH, cs.STREAM_CHUNK))}
    del km_cols, stream_cols
    torch.cuda.synchronize()
    cs.log(f"one-rank references in {time.perf_counter() - t_start:.1f} s ({card})")
    spec = cs.mesh_spec()
    t0 = time.perf_counter()
    with cs.mesh_world(spec) as world:
        result = cs.mesh_phase(card, dev, runs, world, spec, time.perf_counter() - t0)
        cs.log(f"phase 16 {result['seconds']:.1f} s")
        mesh2d = cs.mesh2d_phase(card, dev, runs, world, spec, fleet_models)
    cs.log("mesh2d: " + __import__("json").dumps(mesh2d, default=str))
    cs.log(f"phase 17 {mesh2d['seconds']:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""chip_smoke.py's phase 16 (data-parallel training over a mesh of ranks)
alone on the card.

    python3 scripts/chip_mesh_phase.py      # from the repository root

It builds the sparse kernels, fits phase 3's dense LR, sparse LR and
KMeans on one rank from the same seeds (the references phase 16 holds the
mesh fits to, with the sparse LR's plain-loss fit of phase 4), and runs
`chip_smoke.mesh_phase`, which prints each fit and exits non-zero on a
failed gate. About two minutes on an H100."""
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
    cuda_build.load_all(("sparse_kernels",))
    sk.build()
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
    del s_idx, s_vals, s_y
    runs["kmeans"] = {"model": cs.kmeans_estimator().fit(Table({"features": cs.kmeans_data(dev)}))}
    torch.cuda.synchronize()
    cs.log(f"one-rank references in {time.perf_counter() - t_start:.1f} s ({card})")
    result = cs.mesh_phase(card, dev, runs)
    cs.log(f"phase 16 {result['seconds']:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

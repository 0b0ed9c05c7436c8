"""Distance measures between rows of points and centroids, batched.

Port of flink_ml_tpu/ops/distance.py (the reference's common/distance/
DistanceMeasure.java:64, with its euclidean, manhattan and cosine
variants). `pairwise` gives the full (n, k) matrix. Euclidean and cosine
are one `X @ C.T` matmul plus norms, in the same expanded form as the JAX
package, so nearest-centroid assignments agree with it. A float32 matmul on
the card follows `torch.backends.cuda.matmul.allow_tf32`, which PyTorch
leaves False.

Manhattan has no matmul form: it takes |x - c| of every (point, centroid,
feature) triple. That (n, k, d) tensor is cut into blocks of rows, each at
most MANHATTAN_BLOCK_ELEMENTS elements, so the full-width KMeans config
(1M x 10 x 100, 4 GB in float32) never materialises it.
"""

from __future__ import annotations

import torch

EUCLIDEAN = "euclidean"
MANHATTAN = "manhattan"
COSINE = "cosine"

#: elements of the (rows, k, d) difference tensor one manhattan block holds
MANHATTAN_BLOCK_ELEMENTS = 1 << 25


class DistanceMeasure:
    name: str = ""

    @staticmethod
    def get_instance(name: str) -> "DistanceMeasure":
        for cls in (EuclideanDistanceMeasure, ManhattanDistanceMeasure, CosineDistanceMeasure):
            if cls.name == name:
                return cls()
        raise ValueError(f"Unsupported distance measure {name!r}")

    def pairwise(self, X, C):
        """Distances between rows of X (n, d) and rows of C (k, d) -> (n, k)."""
        raise NotImplementedError

    def distance(self, a, b):
        return self.pairwise(torch.atleast_2d(a), torch.atleast_2d(b))[0, 0]

    def find_closest(self, X, C):
        """Index of the closest centroid for each row of X -> (n,) int32;
        ties go to the lowest index."""
        return torch.argmin(self.pairwise(X, C), dim=1).to(torch.int32)


class EuclideanDistanceMeasure(DistanceMeasure):
    name = EUCLIDEAN

    def pairwise(self, X, C):
        # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2; the cross term is the matmul
        x2 = torch.sum(X * X, dim=1, keepdim=True)
        c2 = torch.sum(C * C, dim=1)[None, :]
        sq = x2 - 2.0 * (X @ C.T) + c2
        return torch.sqrt(torch.clamp(sq, min=0.0))


class ManhattanDistanceMeasure(DistanceMeasure):
    name = MANHATTAN

    def pairwise(self, X, C):
        k, d = C.shape
        rows = max(1, MANHATTAN_BLOCK_ELEMENTS // max(k * d, 1))
        blocks = [
            torch.sum(torch.abs(X[i : i + rows, None, :] - C[None, :, :]), dim=-1)
            for i in range(0, X.shape[0], rows)
        ]
        return torch.cat(blocks) if blocks else X.new_zeros((0, k))


class CosineDistanceMeasure(DistanceMeasure):
    name = COSINE

    def pairwise(self, X, C):
        xn = torch.linalg.vector_norm(X, dim=1, keepdim=True)
        cn = torch.linalg.vector_norm(C, dim=1)[None, :]
        sim = (X @ C.T) / torch.clamp(xn * cn, min=1e-12)
        return 1.0 - sim

"""tpulint for the port: AST-based static analysis of card-traffic and
concurrency hazards, and its runtime twin.

Port of flink_ml_tpu/analysis/. The hazards that make a fit, a transform
or a served request slow or stuck (hidden host syncs, uncounted uploads,
tensors on the card outside the memory ledger, host work inside a
captured graph, graphs made again and again, captures on the serving
path, unbounded queues, untimed waits, channels left open, lock-order
cycles, undeclared fusion and checkpoint contracts, torn checkpoint
writes) are mistakes in the source that a profiler sees only after they
ship. This package holds them statically:

- `source`: the source model (raw text, stripped text, AST, the
  `# tpulint: disable=<rule> -- <reason>` suppressions);
- `engine`: the rule registry, the project scan and suppression
  resolution (an unused suppression is itself a finding);
- `callgraph`: the call graph and its interprocedural summaries;
- `cache`: the content-hashed summary cache of the incremental lint;
- `rules/`: one module a hazard family; each rule carries its own
  documentation (`id`, `title`, `rationale`, `example`);
- `sanitizer`: the runtime recorder of locks, workers and channels
  (`FLINK_ML_TPU_SANITIZE=1`), the dynamic twin of `lock-order` and
  `channel-protocol`.

Run it as `python -m flink_ml_tpu_torch.analysis` (`--list-rules` prints
the catalogue). `tests/test_torch_tpulint.py` keeps the port clean of
unsuppressed findings. It imports neither jax nor the JAX package.
"""

from .engine import Finding, Project, all_rules, get_rule, run  # noqa: F401

__all__ = ["Finding", "Project", "all_rules", "get_rule", "run"]

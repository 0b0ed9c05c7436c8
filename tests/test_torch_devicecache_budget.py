"""config.device_cache_budget and data.devicecache.within_device_budget
against the JAX package's (flink_ml_tpu/config.py:266,
flink_ml_tpu/data/devicecache.py:66), exactly.

- `within_device_budget(nbytes)` on a grid of sizes under the budgets
  None (unbounded: everything fits), 0 (off: nothing fits) and b (fits
  up to b), in both packages;
- the scope sets `device_cache_bytes` and restores it, also when its body
  raises, nested scopes included;
- a `DeviceEpochCache` built inside the scope takes its budget.
"""

import numpy as np
import pytest

from flink_ml_tpu import config as jax_config
from flink_ml_tpu.data import devicecache as jax_devicecache
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.data import devicecache

SIZES = [0, 1, 511, 512, 513, 4096, 1 << 30]
BUDGETS = [None, 0, 512, 1 << 20]


@pytest.mark.parametrize("budget", BUDGETS, ids=repr)
def test_within_device_budget_matches_jax(budget):
    with config.device_cache_budget(budget), jax_config.device_cache_budget(budget):
        assert config.device_cache_bytes == jax_config.device_cache_bytes == budget
        port = [devicecache.within_device_budget(n) for n in SIZES]
        ref = [jax_devicecache.within_device_budget(n) for n in SIZES]
    assert port == ref
    if budget is None:
        assert all(port)
    elif budget == 0:
        assert port == [True] + [False] * (len(SIZES) - 1)  # 0 bytes fit in 0
    else:
        assert port == [n <= budget for n in SIZES]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_the_scope_restores_the_budget_after_an_exception(pkg):
    cfg = config if pkg == "port" else jax_config
    before = cfg.device_cache_bytes
    with pytest.raises(RuntimeError, match="inside"):
        with cfg.device_cache_budget(0):
            with cfg.device_cache_budget(256):
                assert cfg.device_cache_bytes == 256
            assert cfg.device_cache_bytes == 0
            raise RuntimeError("inside")
    assert cfg.device_cache_bytes == before


@pytest.mark.parametrize("budget", BUDGETS, ids=repr)
def test_a_cache_built_in_the_scope_takes_its_budget(budget):
    with config.device_cache_budget(budget):
        cache = devicecache.DeviceEpochCache()
    assert cache.budget_bytes == budget
    assert cache.enabled == (budget != 0)
    assert devicecache.DeviceEpochCache(np.int64(64)).budget_bytes == 64

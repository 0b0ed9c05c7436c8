"""The port's config reads the JAX package's environment variables alike.

Every `FLINK_ML_TPU_*` variable that flink_ml_tpu/config.py reads (found in
its source, so a new one fails `test_every_jax_variable_is_covered` until it
is listed here) is set in a child process that imports both configs; the
port's knob must hold what the JAX package's holds, for values that differ
from the defaults, for values the readers clamp or ignore, and for no
variable set at all. Two variables are the stated exception, as what they
choose does not exist in the port: `FLINK_ML_TPU_USE_PALLAS_SPARSE` (Pallas
or XLA for the sparse products; the port runs its CUDA kernels) and
`FLINK_ML_TPU_COMPILATION_CACHE_DIR` (XLA's persistent compilation cache;
the port's program bank stands alone). ROADMAP C.45.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CONFIG = REPO / "flink_ml_tpu" / "config.py"
PORT_CONFIG = REPO / "flink_ml_tpu_torch" / "config.py"

#: variable -> (the knob both configs set from it, a value other than its default)
READ = {
    "FLINK_ML_TPU_WHOLE_FIT": ("whole_fit", "off"),
    "FLINK_ML_TPU_COLLECTIVE_OVERLAP": ("collective_overlap", "1"),
    "FLINK_ML_TPU_SPARSE_2D": ("sparse_2d", "off"),
    "FLINK_ML_TPU_COLLECTIVE_CHUNK_BYTES": ("collective_chunk_bytes", "12345"),
    "FLINK_ML_TPU_PIPELINE_FUSION": ("pipeline_fusion", "off"),
    "FLINK_ML_TPU_DEVICE_CACHE_BYTES": ("device_cache_bytes", "12345"),
    "FLINK_ML_TPU_INPUT_PREFETCH_DEPTH": ("input_prefetch_depth", "5"),
    "FLINK_ML_TPU_HBM_BUDGET_BYTES": ("hbm_budget_bytes", "1048576"),
    "FLINK_ML_TPU_SERVING_FORM_BUDGET_MS": ("serving_form_budget_ms", "7.5"),
    "FLINK_ML_TPU_MODEL_STORE_BYTES": ("model_store_bytes", "4096"),
    "FLINK_ML_TPU_TRANSIENT_RETRIES": ("transient_retries", "5"),
    "FLINK_ML_TPU_ONLINE_OVERLOAD_POLICY": ("online_overload_policy", "shed_oldest"),
    "FLINK_ML_TPU_SNAPSHOT_HOSTS": ("snapshot_hosts", "3"),
    "FLINK_ML_TPU_SNAPSHOT_RETAINED": ("snapshot_retained", "4"),
    "FLINK_ML_TPU_SNAPSHOT_HOST_DEADLINE_S": ("snapshot_host_deadline_s", "2.5"),
    "FLINK_ML_TPU_RECOVERY_BUDGET": ("recovery_budget", "6"),
    "FLINK_ML_TPU_HOST_HEARTBEAT_TIMEOUT_S": ("host_heartbeat_timeout_s", "3.5"),
    "FLINK_ML_TPU_HANG_FACTOR": ("hang_factor", "9.5"),
    "FLINK_ML_TPU_MODEL_VERSIONS_RETAINED": ("model_versions_retained", "7"),
    "FLINK_ML_TPU_LIFECYCLE_CANARY_RTOL": ("lifecycle_canary_rtol", "0.25"),
    "FLINK_ML_TPU_PROGRAM_BANK_DIR": ("program_bank_dir", "banked-programs"),
    "FLINK_ML_TPU_KERNEL_CACHE_SIZE": ("kernel_cache_size", "17"),
}
#: values each reader clamps (negative budgets, too few hosts or versions)
#: or ignores (an unknown mode or policy, an empty string)
EDGE = {
    "FLINK_ML_TPU_WHOLE_FIT": "bogus", "FLINK_ML_TPU_COLLECTIVE_OVERLAP": "no",
    "FLINK_ML_TPU_SPARSE_2D": "maybe", "FLINK_ML_TPU_PIPELINE_FUSION": "fused",
    "FLINK_ML_TPU_DEVICE_CACHE_BYTES": "0", "FLINK_ML_TPU_INPUT_PREFETCH_DEPTH": "",
    "FLINK_ML_TPU_HBM_BUDGET_BYTES": "-5", "FLINK_ML_TPU_SERVING_FORM_BUDGET_MS": "-1",
    "FLINK_ML_TPU_MODEL_STORE_BYTES": "-3", "FLINK_ML_TPU_TRANSIENT_RETRIES": "-1",
    "FLINK_ML_TPU_ONLINE_OVERLOAD_POLICY": "reject", "FLINK_ML_TPU_SNAPSHOT_HOSTS": "0",
    "FLINK_ML_TPU_SNAPSHOT_RETAINED": "0", "FLINK_ML_TPU_RECOVERY_BUDGET": "-2",
    "FLINK_ML_TPU_MODEL_VERSIONS_RETAINED": "1", "FLINK_ML_TPU_KERNEL_CACHE_SIZE": "0",
    "FLINK_ML_TPU_COLLECTIVE_CHUNK_BYTES": "0", "FLINK_ML_TPU_PROGRAM_BANK_DIR": "",
}
#: read by the JAX package only: the port has no Pallas and no XLA cache
JAX_ONLY = {"FLINK_ML_TPU_USE_PALLAS_SPARSE", "FLINK_ML_TPU_COMPILATION_CACHE_DIR"}

_CHILD = """
import json, sys
from flink_ml_tpu import config as jax_config
from flink_ml_tpu_torch import config as port_config
names = json.loads(sys.argv[1])
print(json.dumps({n: [repr(getattr(jax_config, n)), repr(getattr(port_config, n))]
                  for n in names}))
"""


def _jax_variables():
    return set(re.findall(r"\"(FLINK_ML_TPU_[A-Z0-9_]+)\"", JAX_CONFIG.read_text()))


def _both_configs(values):
    """{knob: [JAX repr, port repr]} in a child whose environment holds
    `values` and no other FLINK_ML_TPU_* variable."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLINK_ML_TPU_")}
    env.update(values, JAX_PLATFORMS="cpu")
    knobs = sorted(knob for knob, _ in READ.values())
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(knobs)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def configs():
    return {"set": _both_configs({k: v for k, (_, v) in READ.items()}),
            "edge": _both_configs(EDGE), "unset": _both_configs({})}


def test_every_jax_variable_is_covered():
    assert _jax_variables() == set(READ) | JAX_ONLY
    assert set(EDGE) <= set(READ)


@pytest.mark.parametrize("variable", sorted(READ))
def test_the_port_reads_the_variable_as_the_jax_package(configs, variable):
    knob, value = READ[variable]
    jax_value, port_value = configs["set"][knob]
    assert port_value == jax_value
    assert port_value != configs["unset"][knob][0], "the test value is the default"
    assert variable in PORT_CONFIG.read_text()


@pytest.mark.parametrize("variable", sorted(EDGE))
def test_a_clamped_or_ignored_value_reads_alike(configs, variable):
    jax_value, port_value = configs["edge"][READ[variable][0]]
    assert port_value == jax_value


@pytest.mark.parametrize("knob", sorted(knob for knob, _ in READ.values()))
def test_the_defaults_agree(configs, knob):
    jax_value, port_value = configs["unset"][knob]
    assert port_value == jax_value


@pytest.mark.parametrize("variable", sorted(JAX_ONLY))
def test_the_xla_only_variables_are_the_stated_exception(variable):
    """Neither is read by the port; its config's docstring says why."""
    source = PORT_CONFIG.read_text()
    doc = source.split('"""')[1]
    assert variable in doc
    assert f'_env("{variable}")' not in source and f'environ.get("{variable}")' not in source

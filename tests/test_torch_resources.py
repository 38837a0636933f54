"""The Spark half of ``utils/resources.py`` in the port: GPU resource
discovery and the Spark conf keys, against the JAX package's TPU
counterparts where the two agree (the ResourceInformation JSON, the
properties parser) and against Spark's ``gpu`` resource contract where they
differ (the keys, ``CUDA_VISIBLE_DEVICES``, ``nvidia-smi``)."""

import json
import os
import stat
import subprocess

import pytest
import torch

from spark_rapids_ml_tpu.utils import resources as jax_resources
from spark_rapids_ml_tpu_torch.utils import resources
from spark_rapids_ml_tpu_torch.utils.resources import (
    DISCOVERY_SCRIPT_KEY,
    EXECUTOR_AMOUNT_KEY,
    TASK_AMOUNT_KEY,
    ResourceConf,
    ResourceInformation,
    discover_gpu_addresses,
    discovery_json,
    discovery_script_path,
    resolve_device_ordinal,
)

SCRIPT = discovery_script_path()


def _no_nvidia_smi(monkeypatch):
    monkeypatch.setattr(resources, "_nvidia_smi_indexes", lambda: None)


def test_resource_information_matches_jax():
    info = ResourceInformation("gpu", ["0", "1"])
    assert ResourceInformation.from_json(info.to_json()) == info
    assert info.to_json() == jax_resources.ResourceInformation(
        "gpu", ["0", "1"]).to_json()
    for bad in ('{"name": "gpu"}', '{"addresses": []}'):
        with pytest.raises(ValueError):
            ResourceInformation.from_json(bad)


def test_conf_keys_are_sparks_gpu_keys():
    assert TASK_AMOUNT_KEY == "spark.task.resource.gpu.amount"
    assert EXECUTOR_AMOUNT_KEY == "spark.executor.resource.gpu.amount"
    assert DISCOVERY_SCRIPT_KEY == \
        "spark.executor.resource.gpu.discoveryScript"


def test_conf_from_properties_matches_jax_parser():
    text = """
        # spark-defaults.conf style
        spark.task.resource.gpu.amount 0.25
        spark.executor.resource.gpu.amount=4
        spark.executor.resource.gpu.discoveryScript /opt/get_gpus_resources.sh
        spark.executor.extraJavaOptions=-Dfoo=bar -Dbaz=qux
        """
    conf = ResourceConf.from_properties(text)
    ref = jax_resources.ResourceConf.from_properties(text)
    assert conf._conf == ref._conf
    assert conf.task_gpu_amount() == 0.25
    assert conf.executor_gpu_amount() == 4
    assert conf.discovery_script() == "/opt/get_gpus_resources.sh"
    assert conf.get("spark.executor.extraJavaOptions") == \
        "-Dfoo=bar -Dbaz=qux"
    empty = ResourceConf()
    assert empty.task_gpu_amount() == 0.0 and empty.executor_gpu_amount() == 0
    assert empty.discovery_script() is None


def test_cuda_visible_devices_pins_the_addresses(monkeypatch):
    _no_nvidia_smi(monkeypatch)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert discover_gpu_addresses() == ["2", "3"]
    assert json.loads(discovery_json()) == {"name": "gpu",
                                            "addresses": ["2", "3"]}
    # set but empty: CUDA shows this process no GPU
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert discover_gpu_addresses() == []


def test_nvidia_smi_then_torch_on_request(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(resources, "_nvidia_smi_indexes", lambda: ["0", "1"])
    assert discover_gpu_addresses() == ["0", "1"]
    _no_nvidia_smi(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert discover_gpu_addresses() == []          # torch only on request
    assert discover_gpu_addresses(probe_torch=True) == ["0", "1", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert discover_gpu_addresses(probe_torch=True) == []


def test_nvidia_smi_listing_is_parsed(monkeypatch):
    class Done:
        returncode = 0
        stdout = "0\n1\n\n"

    monkeypatch.setattr(resources.subprocess, "run", lambda *a, **k: Done())
    assert resources._nvidia_smi_indexes() == ["0", "1"]

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(resources.subprocess, "run", missing)
    assert resources._nvidia_smi_indexes() is None


def test_task_gpu_addresses_resolve_the_ordinal():
    res = {"gpu": ResourceInformation("gpu", ["5", "6"])}
    assert resolve_device_ordinal(-1, task_resources=res) == 5
    assert resolve_device_ordinal(2, task_resources=res) == 2
    # a tpu resource is not this package's: the env, then ordinal 0
    tpu = {"tpu": ResourceInformation("tpu", ["4"])}
    assert resolve_device_ordinal(
        -1, task_resources=tpu,
        env={"SPARK_RAPIDS_ML_TORCH_DEVICE": "7"}) == 7
    assert resolve_device_ordinal(-1, task_resources=tpu, env={}) == 0
    # the JAX package reads the same shape under "tpu"
    assert jax_resources.resolve_device_ordinal(
        -1, task_resources={"tpu": jax_resources.ResourceInformation(
            "tpu", ["5"])}) == 5


def test_discovery_script_is_packaged_and_executable():
    assert os.path.basename(SCRIPT) == "get_gpus_resources.sh"
    assert os.stat(SCRIPT).st_mode & stat.S_IXUSR
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "pyproject.toml")) as f:
        assert '"scripts/*.sh"' in f.read()
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "MANIFEST.in")) as f:
        assert "spark_rapids_ml_tpu_torch/scripts/*.sh" in f.read()


@pytest.mark.parametrize("visible,want", [
    ("0,1", ["0", "1"]),
    (" 3 , 1 ", ["3", "1"]),
    (",", []),
    ("", []),
])
def test_discovery_script_output(visible, want):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible)
    out = subprocess.run([SCRIPT], capture_output=True, text=True, env=env,
                         timeout=30)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == {"name": "gpu",
                                              "addresses": want}


@pytest.mark.parametrize("listing,want", [
    ("echo 0; echo 1", ["0", "1"]),   # nvidia-smi lists two GPUs
    ("exit 9", []),                    # nvidia-smi fails: no driver
    ("true", []),                      # nvidia-smi lists nothing
])
def test_discovery_script_asks_nvidia_smi_without_pinning(tmp_path, listing,
                                                         want):
    """No CUDA_VISIBLE_DEVICES: the script takes nvidia-smi's index listing
    (a stand-in first on the PATH), and prints [] when it finds nothing."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text(f"#!/bin/sh\n{listing}\n")
    fake.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env["PATH"] = f"{tmp_path}:/usr/bin:/bin"
    out = subprocess.run([SCRIPT], capture_output=True, text=True, env=env,
                         timeout=30)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == {"name": "gpu", "addresses": want}

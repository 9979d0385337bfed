"""The port's GPU deployment (``tpulab_torch/examples/deploy/``), parsed on
the CPU: the manifest asks for an NVIDIA GPU and no TPU, runs a module of
``tpulab_torch.examples`` whose own argument parser takes the manifest's
arguments, and its ports are that module's; the image copies the port
and nothing of the reference package.  Building the image needs the
network and is not run here."""

import importlib
import os

import pytest
import yaml

REPO = __file__.rsplit("/tests/", 1)[0]
DEPLOY = os.path.join(REPO, "tpulab_torch", "examples", "deploy")


def _read(*parts):
    with open(os.path.join(DEPLOY, *parts)) as f:
        return f.read()


@pytest.fixture(scope="module")
def manifest():
    docs = list(yaml.safe_load_all(_read("k8s", "deployment.yaml")))
    return {d["kind"]: d for d in docs}


@pytest.fixture(scope="module")
def server(manifest):
    (c,) = manifest["Deployment"]["spec"]["template"]["spec"]["containers"]
    return c


def _command(server):
    """(module, arguments) of the container's ``python -m`` command."""
    cmd = server["command"]
    assert cmd[:2] == ["python", "-m"]
    return cmd[2], cmd[3:]


def test_the_pod_asks_for_one_gpu_and_no_tpu(manifest, server):
    assert server["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    spec = manifest["Deployment"]["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in spec["tolerations"]
    assert not any(k.startswith("cloud.google.com")
                   for k in spec["nodeSelector"])
    assert "env" not in server and "volumes" not in spec


def test_the_command_is_an_example_whose_parser_takes_its_arguments(server):
    module, args = _command(server)
    assert module.startswith("tpulab_torch.examples.")
    ns = importlib.import_module(module).build_parser().parse_args(args)
    assert (ns.model, ns.uint8, ns.batching, ns.device) == (
        "resnet50", True, True, None)


def test_the_ports_are_the_examples(manifest, server):
    module, args = _command(server)
    ns = importlib.import_module(module).build_parser().parse_args(args)
    ports = {p["name"]: p["containerPort"] for p in server["ports"]}
    assert ports == {"grpc": ns.port, "metrics": ns.metrics_port}
    assert manifest["Deployment"]["spec"]["template"]["metadata"][
        "annotations"]["prometheus.io/port"] == str(ns.metrics_port)
    for probe in ("readinessProbe", "livenessProbe"):
        assert server[probe]["grpc"] == {"port": ns.port}
    assert server["readinessProbe"]["initialDelaySeconds"] >= 60
    (svc_port,) = manifest["Service"]["spec"]["ports"]
    assert svc_port["port"] == svc_port["targetPort"] == ns.port
    assert manifest["Service"]["spec"]["selector"] == \
        manifest["Deployment"]["spec"]["selector"]["matchLabels"]


def test_the_image_runs_the_same_command(server):
    """The Dockerfile's entry point and default arguments are the
    manifest's command, its base image is named, and it copies the port
    and names nothing of the reference package."""
    import json

    text = _read("Dockerfile")
    lines = text.replace("\\\n", " ").splitlines()
    entry = next(json.loads(line.split(None, 1)[1]) for line in lines
                 if line.startswith("ENTRYPOINT"))
    cmd = next(json.loads(line.split(None, 1)[1]) for line in lines
               if line.startswith("CMD"))
    assert entry + cmd == server["command"]
    assert "COPY tpulab_torch/ tpulab_torch/" in text
    assert "tpulab/" not in text and "jax" not in text.lower()
    base = next(line for line in lines if line.startswith("ARG BASE="))
    assert "cuda" in base and "devel" in base       # nvcc for the kernels
    assert any(line.startswith("EXPOSE 50051 9090") for line in lines)


@pytest.mark.parametrize("name", ["Dockerfile", "README.md",
                                  "k8s/deployment.yaml"])
def test_no_file_names_the_tpu_stack(name):
    text = _read(*name.split("/"))
    for word in ("google.com/tpu", "jax", "tpulab_compile_cache"):
        assert word not in text.lower(), word

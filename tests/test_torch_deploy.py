"""The port's deployment (``kmlserver_tpu_torch/deploy/``): its manifests
parse, bind the reference's env contract, claim NVIDIA cards instead of TPU
chips, run the port's modules, encode ``mining/job.py``'s exit-code policy,
and name only knobs of the port's ``KNOB_REGISTRY``; its Dockerfiles copy
only the port and pre-build every kernel and native library the package
has. The twin of ``tests/test_deploy.py``."""

import glob
import importlib.util
import os
import re

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kmlserver_tpu_torch")
DEPLOY = os.path.join(PKG, "deploy")
K8S = os.path.join(DEPLOY, "kubernetes")
MANIFESTS = ("deployment", "statefulset", "serve-gang", "service", "hpa", "pvc", "job",
             "job-multihost")
WORKLOADS = ("deployment", "statefulset", "serve-gang", "job", "job-multihost")
DOCKERFILES = ("Dockerfile.api", "Dockerfile.mining")


def _docs(name):
    with open(os.path.join(K8S, f"{name}.yaml")) as fh:
        return list(yaml.safe_load_all(fh))


def _load(name):
    (doc,) = _docs(name)
    return doc


def _workload(name):
    """The manifest's Deployment / StatefulSet / Job document."""
    return next(d for d in _docs(name) if d["kind"] in ("Deployment", "StatefulSet", "Job"))


def _container(name):
    return _workload(name)["spec"]["template"]["spec"]["containers"][0]


def _env(container):
    return {e["name"]: e for e in container["env"]}


def test_all_manifests_parse():
    paths = glob.glob(os.path.join(K8S, "*.yaml"))
    assert sorted(os.path.basename(p)[:-5] for p in paths) == sorted(MANIFESTS)
    for p in paths + [os.path.join(DEPLOY, "argocd_manifest.yaml")]:
        with open(p) as fh:
            docs = list(yaml.safe_load_all(fh))
            assert docs and all(d is not None for d in docs), p


def _assert_exit_code_policy(job):
    """The podFailurePolicy encodes the port's mining/job.py contract
    exactly: 64 -> FailJob, 75 and 76 -> Ignore, evictions ignored."""
    from kmlserver_tpu_torch.mining.job import (
        EXIT_FATAL_CONFIG,
        EXIT_RANK_DEAD,
        EXIT_RESUMABLE,
        RETRYABLE_EXIT_CODES,
    )

    spec = job["spec"]
    assert spec["template"]["spec"]["restartPolicy"] == "Never"
    assert spec["activeDeadlineSeconds"] > 0
    rules = spec["podFailurePolicy"]["rules"]
    by_action = {r["action"]: r["onExitCodes"]["values"] for r in rules if "onExitCodes" in r}
    assert by_action == {"FailJob": [EXIT_FATAL_CONFIG], "Ignore": sorted(RETRYABLE_EXIT_CODES)}
    assert (EXIT_FATAL_CONFIG, sorted(RETRYABLE_EXIT_CODES)) == (64, [75, 76])
    assert {EXIT_RESUMABLE, EXIT_RANK_DEAD} == set(RETRYABLE_EXIT_CODES)
    assert any(
        c.get("type") == "DisruptionTarget"
        for rule in rules
        for c in rule.get("onPodConditions", [])
    )


@pytest.mark.parametrize("name", ["job", "job-multihost"])
def test_job_exit_code_policy(name):
    _assert_exit_code_policy(_workload(name))


def test_job_env_contract_one_card_and_volume():
    job = _load("job")
    spec = job["spec"]["template"]["spec"]
    container = spec["containers"][0]
    names = set(_env(container))
    assert {
        "BASE_DIR", "DATASETS_DIR", "REGEX_FILENAME", "MIN_SUPPORT",
        "RECOMMENDATIONS_FILE", "BEST_TRACKS_FILE", "DATA_INVALIDATION_FILE",
        "TOP_TRACKS_SAVE_PERCENTILE",
    } <= names
    assert {"KMLS_CKPT_ENABLED", "KMLS_CKPT_DIR", "KMLS_LEASE_TTL_S"} <= names
    assert job["spec"]["ttlSecondsAfterFinished"] == 1200
    assert "Force=true" in job["metadata"]["annotations"]["argocd.argoproj.io/sync-options"]
    claims = [v["persistentVolumeClaim"]["claimName"] for v in spec["volumes"]]
    assert claims == ["fast-api-claim"]
    # the reference's four chips are one process's dp axis; the port runs
    # that axis as ranks, so the single-pod Job takes one card
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "1"


def test_job_multihost_one_rank_per_pod_and_card():
    docs = _docs("job-multihost")
    service = next(d for d in docs if d["kind"] == "Service")
    job = next(d for d in docs if d["kind"] == "Job")
    spec = job["spec"]
    assert spec["completionMode"] == "Indexed"
    assert spec["completions"] == spec["parallelism"] == 2
    pod = spec["template"]["spec"]
    container = pod["containers"][0]
    env = _env(container)
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "1"
    # the env triple parallel/distributed.py reads
    from kmlserver_tpu_torch.parallel import distributed

    assert {distributed.COORDINATOR_ENV, distributed.NUM_PROCESSES_ENV,
            distributed.PROCESS_ID_ENV} <= set(env)
    rank_ref = env["KMLS_PROCESS_ID"]["valueFrom"]["fieldRef"]["fieldPath"]
    assert "job-completion-index" in rank_ref
    assert int(env["KMLS_NUM_PROCESSES"]["value"]) == spec["completions"]
    host, port = env["KMLS_COORDINATOR_ADDRESS"]["value"].rsplit(":", 1)
    assert host == f"{job['metadata']['name']}-0.{service['metadata']['name']}"
    assert pod["subdomain"] == service["metadata"]["name"]
    assert service["spec"]["clusterIP"] == "None"
    assert service["spec"]["publishNotReadyAddresses"] is True
    assert int(port) == service["spec"]["ports"][0]["port"]
    assert service["spec"]["selector"].items() <= spec["template"]["metadata"]["labels"].items()
    # the vocab axis spans the two ranks: dp 1 x tp = the world size
    from kmlserver_tpu_torch.parallel.mesh import parse_mesh_shape

    dp, tp = parse_mesh_shape(env["KMLS_MESH_SHAPE"]["value"])
    assert dp * tp == spec["completions"] and tp > 1
    assert env["KMLS_MODEL_LAYOUT"]["value"] == "sharded"
    assert float(env["KMLS_RANK_TIMEOUT_S"]["value"]) > 0
    assert float(env["KMLS_RANK_HEARTBEAT_S"]["value"]) > 0
    claims = [v["persistentVolumeClaim"]["claimName"] for v in pod["volumes"]]
    assert claims == ["fast-api-claim"]
    # the route across pods is unmeasured, and the manifest says so
    with open(os.path.join(K8S, "job-multihost.yaml")) as fh:
        assert "Unmeasured" in fh.read()


def test_deployment_env_contract_probes_and_gpu():
    dep = _load("deployment")
    spec = dep["spec"]["template"]["spec"]
    container = spec["containers"][0]
    assert {
        "VERSION", "BASE_DIR", "PICKLE_DIR", "RECOMMENDATIONS_FILE",
        "BEST_TRACKS_FILE", "DATA_INVALIDATION_FILE", "K_BEST_TRACKS",
        "POLLING_WAIT_IN_MINUTES", "ARGO_CD_SYNC_BUSTER",
        "KMLS_REQUEST_DEADLINE_MS", "KMLS_REPLICA_EJECT_THRESHOLD",
        "KMLS_REPLICA_PROBE_INTERVAL_S", "KMLS_REDISPATCH_MAX_RETRIES",
    } <= set(_env(container))
    assert dep["spec"]["replicas"] == 3
    assert container["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert container["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert spec["volumes"][0]["persistentVolumeClaim"]["claimName"] == "fast-api-claim"


@pytest.mark.parametrize("name", WORKLOADS)
def test_workloads_claim_an_h100_not_a_tpu(name):
    """nvidia.com/gpu with requests == limits, the H100 node selector and
    the nvidia.com/gpu toleration — nothing of the TPU's left."""
    pod = _workload(name)["spec"]["template"]["spec"]
    res = pod["containers"][0]["resources"]
    assert res["requests"]["nvidia.com/gpu"] == res["limits"]["nvidia.com/gpu"] == "1"
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"} in pod[
        "tolerations"]
    env = _env(pod["containers"][0])
    assert env["KMLS_TORCH_DEVICE"]["value"] == "cuda"


@pytest.mark.parametrize("relpath", [f"kubernetes/{m}.yaml" for m in MANIFESTS]
                         + ["argocd_manifest.yaml"] + [f"docker/{d}" for d in DOCKERFILES])
def test_nothing_of_the_tpu_or_jax_left(relpath):
    """No TPU resource, TPU node label, JAX/XLA env or setting, and no path
    or module of the JAX package."""
    with open(os.path.join(DEPLOY, relpath)) as fh:
        text = fh.read()
    assert "google.com/tpu" not in text
    assert "gke-tpu" not in text
    assert not re.search(r"JAX_|jax[._]|XLA", text), relpath
    assert "kmlserver_tpu/" not in text and "kmlserver_tpu." not in text


@pytest.mark.parametrize("name", WORKLOADS)
def test_commands_name_port_modules_that_exist(name):
    command = _container(name)["command"]
    assert command[:2] == ["python", "-m"]
    module = command[2]
    assert module.startswith("kmlserver_tpu_torch.")
    assert importlib.util.find_spec(module) is not None, module
    want = ("kmlserver_tpu_torch.mining.job" if name.startswith("job")
            else "kmlserver_tpu_torch.serving.server")
    assert module == want


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_env_knob_is_registered(name):
    """Each KMLS_* the manifest binds is a knob of the port's registry;
    the rest are the reference's env contract names."""
    from kmlserver_tpu_torch.config import KNOB_REGISTRY, KNOBS_ABSENT

    for env_name in _env(_container(name)):
        if env_name.startswith("KMLS_"):
            assert env_name in KNOB_REGISTRY, env_name
            assert env_name not in KNOBS_ABSENT
            assert KNOB_REGISTRY[env_name] in (
                ("mining", "both") if name.startswith("job") else ("serving", "both"))


def test_statefulset_fleet_identity_contract():
    docs = _docs("statefulset")
    svc = next(d for d in docs if d["kind"] == "Service")
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    assert svc["spec"]["clusterIP"] == "None"
    assert sts["spec"]["serviceName"] == svc["metadata"]["name"]
    assert svc["spec"]["selector"] == sts["spec"]["selector"]["matchLabels"]
    spec = sts["spec"]["template"]["spec"]
    container = spec["containers"][0]
    env = _env(container)
    assert env["KMLS_FLEET_SELF"]["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.name"
    name = sts["metadata"]["name"]
    peers = env["KMLS_FLEET_PEERS"]["value"].split(",")
    assert sorted(peers) == [f"{name}-{i}" for i in range(sts["spec"]["replicas"])]
    assert container["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert container["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert spec["volumes"][0]["persistentVolumeClaim"]["claimName"] == "fast-api-claim"
    assert sts["spec"]["podManagementPolicy"] == "Parallel"


def test_serve_gang_identity_and_bootstrap_contract():
    docs = _docs("serve-gang")
    svc = next(d for d in docs if d["kind"] == "Service")
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    assert svc["spec"]["clusterIP"] == "None"
    assert svc["spec"]["publishNotReadyAddresses"] is True
    assert sts["spec"]["serviceName"] == svc["metadata"]["name"]
    assert svc["spec"]["selector"] == sts["spec"]["selector"]["matchLabels"]
    spec = sts["spec"]["template"]["spec"]
    container = spec["containers"][0]
    env = _env(container)
    rank_ref = env["KMLS_SERVE_GANG_RANK"]["valueFrom"]["fieldRef"]["fieldPath"]
    assert "apps.kubernetes.io/pod-index" in rank_ref
    assert int(env["KMLS_SERVE_GANG_SIZE"]["value"]) == sts["spec"]["replicas"]
    host, port = env["KMLS_SERVE_GANG_COORDINATOR"]["value"].rsplit(":", 1)
    assert host == f"{sts['metadata']['name']}-0.{svc['metadata']['name']}"
    assert int(port) == int(env["KMLS_SERVE_GANG_PORT"]["value"])
    mesh_port = next(p for p in svc["spec"]["ports"] if p["name"] == "mesh")
    assert mesh_port["port"] == int(port)
    assert int(port) in {p["containerPort"] for p in container["ports"]}
    assert spec["subdomain"] == svc["metadata"]["name"]
    assert sts["spec"]["podManagementPolicy"] == "Parallel"
    assert container["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert container["livenessProbe"]["httpGet"]["path"] == "/healthz"


def test_hpa_scales_on_the_ports_utilization_signal():
    from kmlserver_tpu_torch.serving.metrics import UTILIZATION_SERIES

    hpa = _load("hpa")
    dep = _load("deployment")
    ref = hpa["spec"]["scaleTargetRef"]
    assert (ref["kind"], ref["name"]) == ("Deployment", dep["metadata"]["name"])
    assert hpa["spec"]["minReplicas"] == dep["spec"]["replicas"]
    assert hpa["spec"]["maxReplicas"] > hpa["spec"]["minReplicas"]
    pods = next(m for m in hpa["spec"]["metrics"] if m["type"] == "Pods")
    assert pods["pods"]["metric"]["name"] == UTILIZATION_SERIES
    millis = pods["pods"]["target"]["averageValue"]
    assert millis.endswith("m") and 0 < int(millis[:-1]) < 1000
    behavior = hpa["spec"]["behavior"]
    assert (behavior["scaleUp"]["stabilizationWindowSeconds"]
            < behavior["scaleDown"]["stabilizationWindowSeconds"])
    with open(os.path.join(K8S, "hpa.yaml")) as fh:
        raw = fh.read()
    assert "KMLS_FORECAST_UTIL_CAP" in raw and "kmls_utilization_forecast" in raw


def test_service_pvc_and_argocd():
    svc = _load("service")
    port = svc["spec"]["ports"][0]
    assert svc["spec"]["type"] == "NodePort"
    assert (port["port"], port["targetPort"], port["nodePort"]) == (80, 80, 31000)
    assert svc["spec"]["selector"] == {"app": "fast-api"}
    pvc = _load("pvc")
    assert pvc["metadata"]["name"] == "fast-api-claim"
    assert pvc["spec"]["accessModes"] == ["ReadWriteMany"]
    with open(os.path.join(DEPLOY, "argocd_manifest.yaml")) as fh:
        app = yaml.safe_load(fh)
    sync = app["spec"]["syncPolicy"]["automated"]
    assert sync["prune"] is True and sync["selfHeal"] is True
    path = app["spec"]["source"]["path"].rstrip("/")
    assert path == "kmlserver_tpu_torch/deploy/kubernetes"
    assert os.path.isdir(os.path.join(REPO, path))


@pytest.mark.parametrize("dockerfile", DOCKERFILES)
def test_dockerfiles_copy_only_the_port_and_prebuild_everything(dockerfile):
    with open(os.path.join(DEPLOY, "docker", dockerfile)) as fh:
        text = fh.read()
    base = re.search(r"^FROM (\S+)", text, re.M).group(1)
    assert "cuda12.8" in base and "devel" in base
    copies = re.findall(r"^COPY (.+)$", text, re.M)
    assert copies == ["kmlserver_tpu_torch/ /srv/kmlserver_tpu_torch/"]
    assert "native/" not in " ".join(copies)
    assert re.search(r"^ENV PYTHONPATH=/srv$", text, re.M)
    # cuda_build / nativelib put their libraries under the package's parent
    from kmlserver_tpu_torch.ops import cuda_build
    from kmlserver_tpu_torch.utils import nativelib

    assert cuda_build.BUILD_DIR.parents[1] == nativelib.BUILD_DIR.parents[1] == __import__(
        "pathlib").Path(PKG).parent
    kernels = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(PKG, "ops", "csrc", "*.cu")))
    natives = sorted(os.path.basename(p)[:-4]
                     for p in glob.glob(os.path.join(PKG, "native", "*.cpp")))
    assert kernels and natives
    build = re.search(r"cuda_build\.build\(n\) for n in \(([^)]*)\)", text).group(1)
    assert sorted(re.findall(r"'(\w+)'", build)) == kernels
    build = re.search(r"nativelib\.build\(n\) for n in \(([^)]*)\)", text).group(1)
    assert sorted(re.findall(r"'(\w+)'", build)) == natives
    cmd = re.search(r"^CMD (.+)$", text, re.M).group(1)
    want = ("kmlserver_tpu_torch.serving.server" if dockerfile.endswith("api")
            else "kmlserver_tpu_torch.mining.job")
    assert f'"{want}"' in cmd


def test_images_match_the_manifests():
    """The serving manifests run the API image, the Jobs the mining one."""
    for name in WORKLOADS:
        image = _container(name)["image"]
        assert image.startswith("ghcr.io/example/kmlserver-tpu-torch-")
        assert image.split(":")[0].endswith("-mining" if name.startswith("job") else "-api")

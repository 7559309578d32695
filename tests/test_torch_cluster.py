"""The port's cluster launch paths (``torchft_tpu_torch/examples/cluster/``)
against the reference's (``examples/cluster/``): for the same arguments,
with the device count given as the reference's chips and the port's GPUs,
both generators write the same env contract for every replica group, the
same trainer flags (DiLoCo on and off) and the same lighthouse flags, and
differ only in the entry module and the device resources. Every trainer
argv the port generates parses under the port's ``train_llama_hsdp``
parser. Nothing is applied or submitted: generation and ``--dry-run``
only."""

from __future__ import annotations

import copy
import importlib.util
import os
import re
import shlex

import pytest
import yaml

from torchft_tpu_torch.examples import train_llama_hsdp
from torchft_tpu_torch.examples.cluster import _common, gke_runner, slurm_runner
from torchft_tpu_torch.models.llama import CONFIGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "examples", "cluster")


def _load_ref(name: str):
    """The reference's runner module, loaded from its file (it puts its own
    folder on ``sys.path`` for ``_common``)."""
    spec = importlib.util.spec_from_file_location(f"ref_cluster_{name}",
                                                  os.path.join(REF_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_common = _load_ref("_common")
ref_gke = _load_ref("gke_runner")
ref_slurm = _load_ref("slurm_runner")

# (replica groups, devices a group, extra training args)
CASES = {
    "defaults_fsdp_fills": (4, 4, []),
    "diloco": (2, 4, ["--semi-sync-method", "diloco"]),
    "tp2": (3, 4, ["--tp", "2"]),
    "sp2_fsdp2_8b": (2, 4, ["--sp", "2", "--fsdp", "2", "--model-config", "llama3_8b",
                            "--local-batch-size", "4", "--steps", "500"]),
    "one_device": (1, 1, ["--min-replicas", "1", "--semi-sync-method", "diloco"]),
}
TOPOLOGY = {1: "1x1x1", 4: "2x2x1"}


def _gke_docs(mod, argv, tmp_path, name):
    out = tmp_path / f"{name}.yaml"
    mod.main(argv + ["--out", str(out), "--image", "img:test"])
    return list(yaml.safe_load_all(out.read_text()))


def _gke_pair(case, tmp_path):
    groups, devices, extra = CASES[case]
    common = ["--replica-groups", str(groups)] + extra
    ref = _gke_docs(ref_gke, common + ["--tpu-topology", TOPOLOGY[devices]], tmp_path, "ref")
    port = _gke_docs(gke_runner, common + ["--gpus-per-pod", str(devices)], tmp_path, "port")
    return groups, devices, ref, port


def _jobs(docs):
    return [d for d in docs if d["kind"] == "Job"]


def _container(job):
    return job["spec"]["template"]["spec"]["containers"][0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gke_same_contract_flags_and_lighthouse(case, tmp_path):
    groups, devices, ref, port = _gke_pair(case, tmp_path)
    assert [d["kind"] for d in ref] == [d["kind"] for d in port] == \
        ["Deployment", "Service"] + ["Job"] * groups
    # the lighthouse: the same flags and Service; the port's module
    ref_lh, port_lh = (d[0]["spec"]["template"]["spec"]["containers"][0] for d in (ref, port))
    assert ref_lh["args"] == port_lh["args"]
    assert ref_lh["command"] == ["python", "-m", "torchft_tpu.lighthouse"]
    assert port_lh["command"] == ["python", "-m", "torchft_tpu_torch.lighthouse"]
    assert ref[1] == port[1]
    for rid, (rj, pj) in enumerate(zip(_jobs(ref), _jobs(port))):
        rc, pc = _container(rj), _container(pj)
        assert pc["env"] == rc["env"]
        assert {e["name"]: e["value"] for e in pc["env"]}["REPLICA_GROUP_ID"] == str(rid)
        assert pc["args"] == rc["args"]
        assert ("--diloco" in pc["args"]) == ("diloco" in CASES[case][2])
        # the entry module and the device resources, nothing else
        assert rc["command"] == ["python", "examples/train_llama_hsdp.py"]
        assert pc["command"] == ["torchrun", "--standalone", f"--nproc-per-node={devices}",
                                 "-m", "torchft_tpu_torch.examples.train_llama_hsdp"]
        assert rc["resources"] == {"requests": {"google.com/tpu": devices},
                                   "limits": {"google.com/tpu": devices}}
        assert pc["resources"] == {"requests": {"nvidia.com/gpu": devices},
                                   "limits": {"nvidia.com/gpu": devices}}
        assert set(rj["spec"]["template"]["spec"]["nodeSelector"]) == {
            "cloud.google.com/gke-tpu-accelerator", "cloud.google.com/gke-tpu-topology"}
        assert pj["spec"]["template"]["spec"]["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert _without_device(rj) == _without_device(pj)


def _without_device(job):
    """A Job with its entry module and device resources taken out."""
    job = copy.deepcopy(job)
    pod = job["spec"]["template"]["spec"]
    pod.pop("nodeSelector")
    pod.pop("volumes", None)  # the port's /dev/shm for NCCL
    for key in ("command", "resources", "volumeMounts"):
        pod["containers"][0].pop(key, None)
    return job


@pytest.mark.parametrize("case", sorted(CASES))
def test_gke_trainer_argv_parses_under_the_port_trainer(case, tmp_path):
    _, devices, _, port = _gke_pair(case, tmp_path)
    for job in _jobs(port):
        args = train_llama_hsdp.parse_args(_container(job)["args"])
        assert args.config == "llama3_8b" and args.config in CONFIGS
        assert args.fsdp * args.sp * args.tp == devices
        assert args.diloco == ("diloco" in CASES[case][2])
        if args.diloco:
            assert (args.sync_every, args.num_fragments, args.fragment_sync_delay) == (20, 2, 1)


def _slurm(mod, argv, capsys):
    mod.main(argv + ["--dry-run"])
    out = capsys.readouterr().out
    parts = re.split(r"^# === (\S+) ===\n", out, flags=re.M)[1:]
    return dict(zip(parts[::2], parts[1::2]))


def _exec(script: str) -> list:
    """The script's ``exec`` command as an argv (continuations joined)."""
    body = script.replace("\\\n", " ")
    line = next(ln for ln in body.splitlines() if ln.startswith("exec "))
    return shlex.split(line)[1:]


def _lines(script: str, prefix: str) -> list:
    return [ln for ln in script.splitlines() if ln.startswith(prefix)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_slurm_same_contract_flags_and_lighthouse(case, capsys):
    groups, devices, extra = CASES[case]
    common = ["--replica-groups", str(groups), "--lighthouse-host", "lh0"] + extra
    ref = _slurm(ref_slurm, common + ["--chips-per-node", str(devices)], capsys)
    port = _slurm(slurm_runner, common + ["--gpus-per-node", str(devices)], capsys)
    names = ["lighthouse.sbatch"] + [f"replica_{r}.sbatch" for r in range(groups)]
    assert list(ref) == list(port) == names
    r_lh, p_lh = _exec(ref["lighthouse.sbatch"]), _exec(port["lighthouse.sbatch"])
    assert r_lh[:3] == ["python", "-m", "torchft_tpu.lighthouse"]
    assert p_lh[:3] == ["python", "-m", "torchft_tpu_torch.lighthouse"]
    assert r_lh[3:] == p_lh[3:]
    assert _lines(ref["lighthouse.sbatch"], "#SBATCH") == _lines(port["lighthouse.sbatch"],
                                                                 "#SBATCH")
    for rid in range(groups):
        r, p = ref[f"replica_{rid}.sbatch"], port[f"replica_{rid}.sbatch"]
        assert _lines(r, "export ") == _lines(p, "export ")
        assert f"export REPLICA_GROUP_ID={rid}" in _lines(p, "export ")
        # the device resources: slurm hands the port's job its GPUs
        sbatch = _lines(r, "#SBATCH")
        assert _lines(p, "#SBATCH") == sbatch[:2] + [f"#SBATCH --gpus-per-node={devices}"] + \
            sbatch[2:]
        r_argv, p_argv = _exec(r), _exec(p)
        # the entry module: the reference's script file, the port's module
        # under torchrun, one rank a GPU
        assert r_argv[0] == "python" and r_argv[1].endswith(
            os.path.join("examples", "train_llama_hsdp.py"))
        assert p_argv[:5] == ["torchrun", "--standalone", f"--nproc-per-node={devices}", "-m",
                              "torchft_tpu_torch.examples.train_llama_hsdp"]
        assert r_argv[2:] == p_argv[5:]
        args = train_llama_hsdp.parse_args(p_argv[5:])
        assert args.config in CONFIGS
        assert args.fsdp * args.sp * args.tp == devices
        assert args.diloco == ("diloco" in extra)


def test_mesh_args_agree_and_refuse_the_same_meshes():
    import argparse

    for gpus, sp, tp, fsdp in [(8, 1, 1, 0), (8, 2, 2, 0), (4, 1, 2, 2), (8, 3, 1, 0),
                               (4, 1, 1, 3)]:
        ns = argparse.Namespace(sp=sp, tp=tp, fsdp=fsdp)
        try:
            want = ref_common.mesh_args(ns, gpus)
        except ValueError:
            with pytest.raises(ValueError, match="GPU count"):
                _common.mesh_args(ns, gpus)
            continue
        assert _common.mesh_args(ns, gpus) == want
    assert _common.DILOCO_TRAINER_FLAGS == ref_common.DILOCO_TRAINER_FLAGS


def test_gke_refuses_a_pod_beyond_one_node(tmp_path):
    with pytest.raises(ValueError, match="1 to 8"):
        _gke_docs(gke_runner, ["--gpus-per-pod", "16"], tmp_path, "port")

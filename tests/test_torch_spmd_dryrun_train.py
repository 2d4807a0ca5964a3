"""The dry run's SPMD fields for the train step
(``repro_torch.launch.dryrun.spmd_record``): one arch of each family
(dense smollm-360m, moe mixtral-8x22b, ssm rwkv6-1.6b, vlm
llava-next-34b, encoder-decoder seamless-m4t-large-v2, hybrid hymba-1.5b) at
``train_4k`` as a DTensor program on torch's fake process group over
16×16 and 2×16×16 under ``tp_fsdp``, on meta tensors: ``spmd_ok``, and
the collectives of ZeRO-3 with tensor parallelism (parameters gathered,
gradients reduce-scattered) filled for the reference's five op types; the
breakdowns by op summing to the totals. smollm-360m's 16×16 FLOPs and
bytes a device are chip_smoke.py's ``SITES_2_13`` entry, which holds the
card's torch to this one's.
The other records are tests/test_torch_spmd_dryrun.py's.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]

TRAIN_ARCHS = ("smollm-360m", "mixtral-8x22b", "rwkv6-1.6b",
               "llava-next-34b", "seamless-m4t-large-v2", "hymba-1.5b")
MESHES = ("single_pod", "multi_pod")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_spmd_ok_train_step_on_both_meshes(arch):
    for mesh_kind in MESHES:
        rec = dryrun.spmd_record(get_config(arch), "train_4k",
                                 make_production_mesh(
                                     multi_pod=mesh_kind == "multi_pod"),
                                 "tp_fsdp")
        assert rec["spmd_ok"] is True, rec
        assert tuple(rec["collective_counts"]) == dryrun.COLLECTIVES
        assert tuple(rec["collective_bytes"]) == dryrun.COLLECTIVES
        assert rec["collective_bytes_total"] == sum(
            rec["collective_bytes"].values()) > 0
        # ZeRO-3 in a train step: parameters gathered, gradients scattered
        assert rec["collective_counts"]["all-gather"] > 0
        assert rec["collective_counts"]["reduce-scatter"] > 0
        for by, total in (("flops_by_op", "flops_per_device"),
                          ("bytes_by_op", "bytes_per_device")):
            assert len(rec[by]) <= dryrun.BY_OP_TOP + 1
            assert sum(rec[by].values()) == rec[total]
        if (arch, mesh_kind) == ("smollm-360m", "single_pod"):
            assert (rec["flops_per_device"], rec["bytes_per_device"]) == \
                _chip_smoke().SITES_2_13[arch]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

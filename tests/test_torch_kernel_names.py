"""``chip_smoke.py``'s ``KERNEL_NAMES`` against the kernels in the sources:
the profile of a train step (``step_breakdown``) and the build phase's
labels attribute each device kernel to its wrapper by these name parts, so
a kernel that is renamed or added without a name part would fall silently
into the profile's "other" group.  Runs on the CPU: ``chip_smoke.py``
imports only the standard library at module level."""

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
sys.path.insert(0, str(ROOT))

import chip_smoke

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def _kernels() -> dict:
    """Every ``__global__`` function of the sources, by name → source."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name in _GLOBAL.findall(src.read_text()):
            found[name] = src.name
    return found


def test_the_sources_have_the_six_kernels_files_and_their_kernels():
    kernels = _kernels()
    assert {s for s in kernels.values()} == {
        "alias_draw.cu", "bfs_frontier.cu", "flash_attention.cu",
        "frame_accum.cu", "rglru_scan.cu", "ssm_scan.cu"}
    assert {"flash_bwd_tc_dkdv_kernel", "flash_bwd_tc_dq_kernel",
            "flash_bwd_tf3_dkdv_kernel", "flash_bwd_tf3_dq_kernel",
            "scan_bwd_ring_kernel", "flash_bf16_kernel"} <= set(kernels)


def test_every_kernel_has_one_wrapper_by_name_part():
    parts = {p: w for w, ps in chip_smoke.KERNEL_NAMES.items() for p in ps}
    for name, src in _kernels().items():
        owners = {w for p, w in parts.items() if name.startswith(p)}
        assert len(owners) == 1, (f"{src}: kernel {name} matches the name "
                                  f"parts of {sorted(owners)} in KERNEL_NAMES")


def test_every_name_part_names_a_kernel():
    kernels = _kernels()
    for wrapper, ps in chip_smoke.KERNEL_NAMES.items():
        for p in ps:
            assert any(k.startswith(p) for k in kernels), (
                f"KERNEL_NAMES[{wrapper!r}] has {p!r}, which starts no "
                f"__global__ function of {CSRC}")


def test_kernel_label_reads_the_new_kernels_mangled_names():
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_13tcb24flash_bwd_tc_dkdv_kernelILi128ELi16EEEvPK13"
        "__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiiiiffNS_2bw10BwdStridesE"
    ) == "flash_bwd_tc_dkdv_kernel<128, 16>"
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_120scan_bwd_ring_kernelILi4EEEvPKfS2_S2_PfS3_ii"
    ) == "scan_bwd_ring_kernel<4>"


def test_kernel_label_reads_the_3xtf32_kernels_mangled_names():
    """The f32 backward's kernels, whose namespace and names hold digits."""
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_13tf325flash_bwd_tf3_dkdv_kernelILi128ELi16EEEvPKfS3_S3_"
        "S3_S3_S3_PfS4_iiiiiffNS_2bw10BwdStridesE"
    ) == "flash_bwd_tf3_dkdv_kernel<128, 16>"
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_13tf323flash_bwd_tf3_dq_kernelILi256ELi4EEEvPKfS3_S3_"
        "S3_S3_S3_PfiiiiiffNS_2bw10BwdStridesE"
    ) == "flash_bwd_tf3_dq_kernel<256, 4>"

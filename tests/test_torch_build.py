"""The kernel build helper's reading of ptxas's ``-v`` report
(igm_tpu_torch.ops._build), on the CPU: kernel names from mangled symbols
and each kernel's registers, stack frame and spills from a saved report."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu_torch.ops import _build  # noqa: E402

NS = "_ZN53_GLOBAL__N__80ca1e8f_20_dropout_attention_cu_efa49c01"


@pytest.mark.parametrize("symbol,name", [
    (NS + "31dropout_attention_dq_mma_kernelEPK13__nv_bfloat16S2_S2_S2_PKfS4_PKlPS0_iifjfi",
     "dropout_attention_dq_mma_kernel"),
    (NS + "28dropout_attention_fwd_kernelI13__nv_bfloat16EEvPKT_S4_S4_PKlPS2_Pfiifjfi",
     "dropout_attention_fwd_kernel<bf16>"),
    (NS + "32dropout_attention_fwd_mma_kernelEPK13__nv_bfloat16S2_S2_PKlPS0_Pfiifjfi",
     "dropout_attention_fwd_mma_kernel"),
    ("_ZN52_GLOBAL__N__5b1c07e2_19_linear_attention_cu_3f6d2a9127linear_attention_mma_kernelEPK13__nv_bfloat16S2_S2_PS0_iiiii",
     "linear_attention_mma_kernel"),
    (NS + "27dropout_attention_dq_kernelIfEEvPKT_S3_S3_S3_PKfS5_PKlPS1_iifjfi",
     "dropout_attention_dq_kernel<float>"),
    ("_ZN51_GLOBAL__N__cc202229_18_group_norm_mish_cu_3252673626group_norm_mish_bwd_kernel"
     "I13__nv_bfloat16Li8EEEvPKT_PKfS6_S4_PS2_PfS8_iiif", "group_norm_mish_bwd_kernel<bf16, 8>"),
    ("_ZN47_GLOBAL__N__0c3f5a11_14_fused_block_cu_6e2b41d722fused_block_mma_kernelILb1EEEvPK13"
     "__nv_bfloat16S3_PKfS5_S5_PS1_PfS7_NS_7MmaPlanEf", "fused_block_mma_kernel<true>"),
    ("_ZN47_GLOBAL__N__0c3f5a11_14_fused_block_cu_6e2b41d722fused_block_mma_kernelILb0EEEvPK13"
     "__nv_bfloat16S3_PKfS5_S5_PS1_PfS7_NS_7MmaPlanEf", "fused_block_mma_kernel<false>"),
    ("_Z15group_norm_mishPKf", "group_norm_mish"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_name(symbol, name):
    assert _build._kernel_name(symbol) == name


def test_resource_usage_reads_the_saved_report(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.resource_usage("dropout_attention") == {}
    dq = NS + "31dropout_attention_dq_mma_kernelEPK13__nv_bfloat16S2_S2_S2_PKfS4_PKlPS0_iifjfi"
    fwd = NS + "28dropout_attention_fwd_kernelIfEEvPKT_S3_S3_PKlPS1_Pfiifjfi"
    report = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{dq}' for 'sm_90a'
ptxas info    : Function properties for {dq}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'
ptxas info    : Function properties for {fwd}
    48 bytes stack frame, 48 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
"""
    _build._target(_build.SOURCES / "dropout_attention.cu").with_suffix(".log").write_text(report)
    assert _build.resource_usage("dropout_attention") == {
        "dropout_attention_dq_mma_kernel": dict(registers=128, stack_frame=0, spill_stores=0,
                                                spill_loads=0),
        "dropout_attention_fwd_kernel<float>": dict(registers=64, stack_frame=48,
                                                    spill_stores=48, spill_loads=32)}


def test_target_is_keyed_by_the_source_and_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a kernel source or to a header the sources share
    (csrc/*.cuh) gives a new library name, so the next build recompiles."""
    monkeypatch.setattr(_build, "SOURCES", tmp_path)
    src, header = tmp_path / "kernel.cu", tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// v1\n")
    first = _build._target(src)
    assert _build._target(src) == first and first.name.startswith("kernel-")
    header.write_text("// v2\n")
    second = _build._target(src)
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert len({first, second, _build._target(src)}) == 3

"""The port's copy of the WSMC capacity model against the reference
package's: every number EQUAL (integers and floats), over the registry x
kv codecs x block sizes, with the same hardware spec on both sides."""
import dataclasses

import pytest

from repro import hw as JHW
from repro.configs import ARCH_IDS, get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.core import classifier as JC, predictor as JP
from repro_torch import hw as THW
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS, get_config as tget
from repro_torch.configs.base import SHAPES as TSHAPES, input_specs
from repro_torch.core import classifier as TC, predictor as TP

MESH = {"data": 1, "model": 1}


def _cls(mod):
    return mod.Classification(category=mod.Category.MEDIUM, alpha=0.8,
                              inc=1.0, slope=0.7, intercept=1e6)


def test_registry_and_configs_equal():
    assert tuple(ARCH_IDS) == tuple(T_ARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(jget(arch)) == dataclasses.asdict(tget(arch))
        assert dataclasses.asdict(jget(arch).reduced()) \
            == dataclasses.asdict(tget(arch).reduced())
    assert {k: dataclasses.asdict(v) for k, v in JSHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in TSHAPES.items()}
    specs = input_specs(tget("internvl2-26b"), TSHAPES["prefill_32k"])
    assert specs["tokens"][1] == "int32"
    assert specs["prefix_embeds"][1] == "bfloat16"
    assert specs["tokens"][0][0] == 32


def test_hardware_specs():
    assert dataclasses.asdict(THW.TPU_V5E) == dataclasses.asdict(JHW.TPU_V5E)
    assert THW.H100.hbm_bytes == 80 * 10**9
    assert THW.H100.hbm_bw == 3.35e12 and THW.H100.peak_flops_bf16 == 989e12
    assert THW.H100.vmem_bytes == 227 * 1024
    assert THW.capacity_from_requirement(1e9, 2e9, THW.TPU_V5E) \
        == JHW.capacity_from_requirement(1e9, 2e9, JHW.TPU_V5E)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_predictor_numbers_equal(arch):
    cj, ct = jget(arch), tget(arch)
    shape_j, shape_t = JSHAPES["decode_32k"], TSHAPES["decode_32k"]
    hw_t = THW.HardwareSpec(**dataclasses.asdict(JHW.TPU_V5E))
    for quant in ("none", "int8", "int4"):
        for kvb in (8, 16, 64):
            pj = JP.MemoryPlan(kv_block_size=kvb, kv_quant=quant)
            pt = TP.MemoryPlan(kv_block_size=kvb, kv_quant=quant)
            assert JP.kv_block_bytes_per_device(cj, shape_j, pj, MESH) \
                == TP.kv_block_bytes_per_device(ct, shape_t, pt, MESH)
            for kernel in ("dense", "tiled"):
                assert JP.prefill_transient_bytes(
                    cj, shape_j, pj, _cls(JC), MESH, prefill_tokens=256,
                    reach=4096, width=2, kernel=kernel) \
                    == TP.prefill_transient_bytes(
                        ct, shape_t, pt, _cls(TC), MESH, prefill_tokens=256,
                        reach=4096, width=2, kernel=kernel)
            for mode in ("paper", "fitted"):
                a = JP.predict(cj, shape_j, pj, _cls(JC), MESH, mode,
                               JHW.TPU_V5E)
                b = TP.predict(ct, shape_t, pt, _cls(TC), MESH, mode, hw_t)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            for budget in (None, 64 * 2**30):
                kw = dict(lanes=4, hbm_budget=budget, avg_context=2048,
                          decode_width=2, prefill_tokens=256,
                          prefill_kernel="tiled")
                assert JP.serving_block_capacity(
                    cj, shape_j, pj, _cls(JC), MESH, hw=JHW.TPU_V5E, **kw) \
                    == TP.serving_block_capacity(
                        ct, shape_t, pt, _cls(TC), MESH, hw=hw_t, **kw)

"""PyTorch port, batch LLM inference (`ray_tpu_torch.llm.batch`,
`build_llm_processor`) over the port's data library, on the CPU.

In process: the processor's stages (tokenize, engine, detokenize) against
the JAX package's on the same batch, the engines given the session's fp32
tiny LLM params: the same token ids and text.

Through the port's runtime (one module-scoped runtime): the processor at
concurrency 2 over uneven blocks returns its rows in input order, each
equal to the in-process engine's on the same seed; configs the engine
stage cannot serve are refused when the processor is built. On the card's
package set (no cloudpickle, pyarrow or pandas, in the driver and every
worker) a pipeline through every exchange and the processor give the
same rows as here.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import batch as j_batch
from ray_tpu_torch import data as t_rd
from ray_tpu_torch.llm import InferenceEngine, build_llm_processor
from ray_tpu_torch.llm import batch as t_batch
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.util.state import list_actors
from tests import test_torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello", "a longer prompt for the batch", "x", "yy zz",
           "batch inference!", "the sixth", "7"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_rt():
    rt.init(num_cpus=4, object_store_memory=128 << 20)
    yield rt
    rt.shutdown()


def test_stages_match_jax(tiny_llm_params):
    """Tokenize, engine and detokenize against the JAX package's stages:
    the same token ids in, the same generated ids (8 greedy tokens, more
    prompts than slots) and the same text out."""
    jcfg, pj = tiny_llm_params
    tcfg = W.tiny_llm_config()
    assert {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__} == {
        f: getattr(tcfg.model, f) for f in tcfg.model.__dataclass_fields__}
    e = tcfg.engine
    jl = JLLMConfig(model_id="tiny", model=jcfg, engine=JEngineConfig(
        max_slots=e.max_slots, max_len=e.max_len,
        prompt_buckets=e.prompt_buckets, eos_token=e.eos_token),
        tokenizer="byte")
    batch = {"idx": np.arange(len(PROMPTS)),
             "prompt": np.array(PROMPTS, dtype=object)}
    jt = j_batch._make_tokenize(jl, "prompt")(dict(batch))
    tt = t_batch._Tokenize(tcfg, "prompt")(dict(batch))
    assert [list(map(int, x)) for x in tt["__token_ids"]] == [
        list(map(int, x)) for x in jt["__token_ids"]]
    je = j_batch._EngineUDF(jl, 8, 0.0)
    je.engine.params = pj
    te = t_batch._EngineUDF(tcfg, 8, 0.0)
    te.engine.params = params_from_numpy(jax.tree.map(np.asarray, pj),
                                         device="cpu")
    jg, tg = je(jt), te(tt)
    assert list(tg) == list(jg) == ["idx", "prompt", "__generated_ids"]
    want = [list(map(int, x)) for x in jg["__generated_ids"]]
    assert [list(map(int, x)) for x in tg["__generated_ids"]] == want
    assert all(len(x) == 8 for x in want)
    jd = j_batch._make_detokenize(jl, "generated")(jg)
    td = t_batch._Detokenize(tcfg, "generated")(tg)
    assert list(td["generated"]) == list(jd["generated"])
    assert list(td["prompt"]) == PROMPTS


def test_processor_rows_in_order_equal_in_process_engine(port_rt):
    """Two engine actors over uneven blocks (4 blocks of 2-3 rows, batches
    of 2): every row comes back in input order with its prompt, its text
    the in-process engine's on the same seed."""
    cfg = W.tiny_llm_config(seed=3)
    ds = t_rd.from_items([{"idx": i, "prompt": p}
                          for i, p in enumerate(PROMPTS + ["ninth", "8"])],
                         override_num_blocks=4)
    proc = build_llm_processor(cfg, max_new_tokens=6, temperature=0.0,
                               batch_size=2, concurrency=2)
    rows = proc(ds).take_all()
    prompts = PROMPTS + ["ninth", "8"]
    assert [r["idx"] for r in rows] == list(range(len(prompts)))
    assert [r["prompt"] for r in rows] == prompts
    assert all(list(r) == ["idx", "prompt", "generated"] for r in rows)
    tok = ByteTokenizer()
    eng = InferenceEngine(cfg.resolve_model(), cfg.engine_config(tok),
                          seed=cfg.seed, device="cpu")
    want = eng.generate([tok.encode(p) for p in prompts], 6, 0.0)
    assert [r["generated"] for r in rows] == [tok.decode(w) for w in want]


@pytest.mark.parametrize("kw, match", [
    (dict(num_gpus_per_replica=0, device="cuda"), "reserve one"),
    (dict(tensor_parallelism=2), "one process a replica"),
])
def test_processor_refuses_configs_at_build(port_rt, kw, match):
    """A CUDA config that reserves no GPU, and tp > 1 (the engine stage is
    one process), raise when the processor is built: no actor starts."""
    import dataclasses
    cfg = dataclasses.replace(W.tiny_llm_config(), **kw)
    before = len(list_actors())   # every actor ever made, dead or alive
    with pytest.raises(ValueError, match=match):
        build_llm_processor(cfg)
    assert len(list_actors()) == before


def test_without_cloudpickle_pyarrow_or_pandas(port_rt, tmp_path):
    """With cloudpickle, pyarrow and pandas unimportable (sys.modules
    entries of None, in the driver and, through a sitecustomize first on
    the path, in every worker), `ray_tpu_torch.data` imports, its edges
    raise an ImportError that names the missing package, and a range ->
    map_batches -> random_shuffle -> sort -> groupby().count() pipeline
    and the fp32 tiny processor give the same rows as with the packages
    present (this process)."""
    block = tmp_path / "block"
    block.mkdir()
    blocked = ("cloudpickle", "pyarrow", "pandas")
    (block / "sitecustomize.py").write_text(
        "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n"
                                 for m in blocked))
    code = textwrap.dedent(f"""
        import json, sys
        for m in {blocked!r}:
            sys.modules[m] = None
        import ray_tpu_torch as rt
        import ray_tpu_torch.data
        from tests import test_torch_dist_workers as W
        rt.init(num_cpus=3, object_store_memory=64 << 20)
        try:
            for edge, name in ((lambda: ray_tpu_torch.data.range(3)
                                .to_pandas(), "pandas"),
                               (lambda: ray_tpu_torch.data.range(3)
                                .take_batch(batch_format="pyarrow"),
                                "pyarrow")):
                try:
                    edge()
                except ImportError as e:
                    assert name in str(e), e
                else:
                    raise AssertionError(name + " was imported")
            print(json.dumps(W.data_scenario()))
        finally:
            rt.shutdown()
        """)
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{REPO}"
               f"{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("missing") == list(blocked)
    want = W.data_scenario()
    assert want.pop("missing") == []
    assert got == want
    assert len(got["sorted"]) == 40 and len(got["generated"]) == 3

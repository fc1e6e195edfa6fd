"""The port's LLM glue and category resolver (avlmaps_torch/utils/llm.py,
utils/category_matching.py) against the JAX package's on the same stubbed
backends.  The OpenAI branch runs against a fake ``openai`` module in
``sys.modules``: no test touches the network."""

import sys
import types

import pytest

from avlmaps_torch.utils import category_matching as tcm
from avlmaps_torch.utils import llm as tllm
from avlmaps_tpu.utils import category_matching as jcm
from avlmaps_tpu.utils import llm as jllm

BOTH = [(tllm, tcm), (jllm, jcm)]


@pytest.fixture
def no_key(monkeypatch):
    monkeypatch.delenv("OPENAI_KEY", raising=False)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)


@pytest.fixture
def stub(monkeypatch):
    """Install ``fn`` as both packages' completion backend."""
    def install(fn):
        monkeypatch.setattr(tllm, "complete_fn", fn)
        monkeypatch.setattr(jllm, "complete_fn", fn)
    return install


class FakeOpenAI(types.ModuleType):
    """Records each completion request and answers from ``reply``."""

    def __init__(self, reply):
        super().__init__("openai")
        self.reply = reply
        self.calls = []
        fake = self

        class Completions:
            def create(self, **kw):
                fake.calls.append(kw)
                text = fake.reply(kw["prompt"])
                return types.SimpleNamespace(
                    choices=[types.SimpleNamespace(text=text)])

        class OpenAI:
            def __init__(self, api_key):
                fake.key = api_key
                self.completions = Completions()

        self.OpenAI = OpenAI


def test_prompts_are_the_jax_packages():
    for name in ("LANDMARK_FEWSHOT", "CODEGEN_FEWSHOT"):
        assert getattr(tllm, name) == getattr(jllm, name)


def test_landmark_parsing(stub):
    prompts = []
    stub(lambda p: prompts.append(p) or " kitchen, toilet\n")
    instr = "go to the kitchen and then the toilet"
    assert tllm.parse_object_goal_instruction(instr) == ["kitchen", "toilet"]
    assert jllm.parse_object_goal_instruction(instr) == ["kitchen", "toilet"]
    assert prompts[0] == prompts[1]


def test_codegen(stub):
    prompts = []
    stub(lambda p: prompts.append(p) or "robot.move_to_object('chair')\n")
    code = tllm.parse_spatial_instruction("find any chairs")
    assert code == jllm.parse_spatial_instruction("find any chairs")
    assert code == "robot.move_to_object('chair')"
    assert prompts[0] == prompts[1]


def test_similar_category(stub):
    prompts = []
    stub(lambda p: prompts.append(p) or "tv_monitor")
    for mod in (tllm, jllm):
        assert mod.parse_similar_category(
            "television", ["tv_monitor", "chair"]) == "tv_monitor"
    assert prompts[0] == prompts[1]


def test_no_backend_raises(stub, no_key):
    stub(None)
    with pytest.raises(RuntimeError, match="avlmaps_torch.utils.llm"):
        tllm.parse_object_goal_instruction("go somewhere")


def test_openai_backend_only_with_a_key(stub, monkeypatch):
    stub(None)
    fake = FakeOpenAI(lambda prompt: " plant, table\n")
    monkeypatch.setitem(sys.modules, "openai", fake)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    assert tllm.parse_object_goal_instruction("plant then table") == [
        "plant", "table"]
    call = fake.calls[-1]
    assert fake.key == "sk-test"
    assert call["model"] == "gpt-3.5-turbo-instruct"
    assert call["stop"] == "\n" and call["temperature"] == 0.0
    assert call["prompt"].endswith("I: plant then table. A:")


@pytest.mark.parametrize("mods", BOTH, ids=["torch", "jax"])
def test_category_exact_and_fuzzy(mods, no_key):
    cm = mods[1]
    assert cm.find_similar_category_id("chair", ["table", "chair"]) == 1
    # no LLM: the difflib fallback picks the closest name
    assert cm.find_similar_category_id("chairs",
                                       ["table", "chair", "sofa"]) == 1


@pytest.mark.parametrize("mods", BOTH, ids=["torch", "jax"])
def test_category_injected_resolver(mods, monkeypatch):
    cm = mods[1]
    monkeypatch.setattr(cm, "llm_resolver", lambda name, cats: "tv_monitor")
    assert cm.find_similar_category_id("television",
                                       ["plant", "tv_monitor"]) == 1


@pytest.mark.parametrize("mods", BOTH, ids=["torch", "jax"])
def test_category_key_branch(mods, stub, monkeypatch):
    """With a key set, both packages ask the LLM; its answer wins over the
    fuzzy match, and an answer outside the list or an error of the client
    falls through to the fuzzy match."""
    cm = mods[1]
    stub(None)
    monkeypatch.setenv("OPENAI_KEY", "sk-test")
    fake = FakeOpenAI(lambda prompt: "tv_monitor")
    monkeypatch.setitem(sys.modules, "openai", fake)
    cats = ["television set", "tv_monitor", "plant"]
    assert cm.find_similar_category_id("television", cats) == 1
    assert "What is television most relevant to among " \
        "television set,tv_monitor,plant. A:" in fake.calls[-1]["prompt"]
    fake.reply = lambda prompt: "sofa"
    assert cm.find_similar_category_id("television", cats) == 0

    def boom(prompt):
        raise ConnectionError("no network")

    fake.reply = boom
    assert cm.find_similar_category_id("television", cats) == 0


def test_category_key_branch_agrees(stub, monkeypatch):
    stub(None)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setitem(sys.modules, "openai",
                        FakeOpenAI(lambda prompt: "bed"))
    for name in ("mattress", "couch", "bed"):
        cats = ["sofa", "bed", "chair"]
        assert tcm.find_similar_category_id(name, cats) == \
            jcm.find_similar_category_id(name, cats)

"""LLM glue: language instruction -> landmarks / robot-API code.

Counterpart of ``avlmaps_tpu/utils/llm.py`` (reference:
avlmaps/utils/llm_utils.py, OpenAI text-davinci-002 few-shot prompting),
with the same prompts.  A pluggable ``complete_fn`` serves any LLM backend
(or a test stub); otherwise the OpenAI client is imported, and only when
an API key (``OPENAI_KEY`` or ``OPENAI_API_KEY``) is set.  Few-shot prompt
content follows the reference's task design (landmark extraction :5-33;
robot-code generation :36-178) with the same robot-API target surface.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

# pluggable completion backend: fn(prompt) -> completion text
complete_fn: Optional[Callable[[str], str]] = None

LANDMARK_FEWSHOT = """\
I: go to the kitchen and then go to the toilet. A: kitchen, toilet
I: go to the chair and then go to another chair. A: chair, chair
I: navigate to the green sofa then find several chairs, finally go to the \
painting. A: green sofa, chairs, painting
I: approach the window in front, turn right and go to the television, and \
finally go by the oven in the kitchen. A: window, television, oven, kitchen
I: walk to the plant first, come back to the table, go into the bedroom, \
and stand next to the bed. A: plant, table, bedroom, bed
"""

CODEGEN_FEWSHOT = """\
# move a bit to the right of the refrigerator.
robot.move_to_right('refrigerator')
###
# move in between the couch and bookshelf.
robot.move_in_between('couch', 'bookshelf')
###
# face the toilet.
robot.face('toilet')
###
# move to the south side of the table.
robot.move_south('table')
###
# move to the west of the chair.
robot.move_west('chair')
###
# turn left 60 degrees.
robot.turn(-60)
###
# find any chairs in the environment.
robot.move_to_object('chair')
###
# with the television on your left.
robot.with_object_on_left('television')
###
# with the television behind you.
robot.face('television')
robot.turn(180)
###
# move forward for 3 meters.
robot.move_forward(3)
###
# move right 2 meters.
robot.turn(90)
robot.move_forward(2)
###
# move back and forth between the chair and the table 3 times.
pos1 = robot.get_pos('chair')
pos2 = robot.get_pos('table')
for i in range(3):
    robot.move_to(pos1)
    robot.move_to(pos2)
###
"""


def _complete(prompt: str, stop=None, max_tokens: int = 128) -> str:
    if complete_fn is not None:
        return complete_fn(prompt)
    key = os.environ.get("OPENAI_KEY") or os.environ.get("OPENAI_API_KEY")
    if not key:
        raise RuntimeError(
            "no LLM backend: set avlmaps_torch.utils.llm.complete_fn or an "
            "OPENAI_KEY")
    import openai

    client = openai.OpenAI(api_key=key)
    resp = client.completions.create(model="gpt-3.5-turbo-instruct",
                                     prompt=prompt, max_tokens=max_tokens,
                                     temperature=0.0, stop=stop)
    return resp.choices[0].text


def parse_object_goal_instruction(language_instr: str) -> List[str]:
    """Instruction -> ordered landmark list
    (reference llm_utils.py:5-33)."""
    prompt = LANDMARK_FEWSHOT + f"I: {language_instr}. A:"
    result = _complete(prompt, stop="\n", max_tokens=64).strip()
    return [x.strip() for x in result.split(",") if x.strip()]


def parse_spatial_instruction(language_instr: str) -> str:
    """Instruction -> executable ``robot.*`` python code
    (reference llm_utils.py:36-178)."""
    prompt = CODEGEN_FEWSHOT + f"# {language_instr}.\n"
    result = _complete(prompt, stop="###", max_tokens=256)
    return result.strip()


def parse_similar_category(class_name: str, classes_list: List[str]) -> str:
    """Resolve a free-form name to the closest listed category
    (reference index_utils.py:8-32)."""
    classes_str = ",".join(classes_list)
    prompt = (
        "Q: What is television most relevant to among tv_monitor,plant,"
        "chair. A:tv_monitor\n"
        "Q: What is drawer most relevant to among tv_monitor,"
        "chest_of_drawers,chair. A:chest_of_drawers\n"
        f"Q: What is {class_name} most relevant to among {classes_str}. A:")
    return _complete(prompt, stop="\n", max_tokens=64).strip()

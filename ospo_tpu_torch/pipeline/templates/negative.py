"""Step-2a contrastive ("negative") prompt-perturbation templates.

Five template families keyed by sub_category, each a 4-step CoT with three
few-shot exemplars; prompt text preserved from
``ospo/templates/template_negative.py:4-246``.  The spatial family injects a
random replacement word into its <replace> exemplar/query (drawn with the
per-perturbation seeded host RNG, matching template_negative.py:54-58).
The non-spatial family supports only <replace>/<drop> and returns
``(None, None)`` for <swap> (template_negative.py:189).
"""

from __future__ import annotations

import random


from ospo_tpu_torch.pipeline.templates.base import ASSISTANT, USER

_STEP_SUFFIX = "Let's think step by step."


def _turns(pairs, final_user):
    msgs = []
    for user, assistant in pairs:
        msgs.append({"role": USER, "content": user})
        msgs.append({"role": ASSISTANT, "content": assistant})
    msgs.append({"role": USER, "content": final_user})
    msgs.append({"role": ASSISTANT, "content": ""})
    return msgs


_FOUR_STEP_HEADER = (
    "You are a helpful assistant that generates object-level contrastive "
    "prompts by following four steps.\n"
)


# --------------------------------------------------------------------------
# attribute (attribute1_* and attribute2)
# --------------------------------------------------------------------------

_ATTR_SYSTEM = (
    _FOUR_STEP_HEADER
    + "Step 1. Identify all objects in the prompt."
    + "Step 2. Identify all object-attribute bindings in the prompt."
    + "Step 3. Apply one of the following transformations to the given prompt: "
    "(1) <replace> an attribute or object with another plausible one, "
    "(2) <swap> two attributes or objects, or (3) <drop> an attribute or object."
    + "Step 4. Generate contrastive prompts based on the transformations."
    + "Always ensure the output has opposing or conflicting semantics compared "
    "to the input. Do not just reorder or repeat the input."
)

_ATTR_EXEMPLARS = (
    (
        "a blue bench and a red car\nGenerate object-level contrastive prompts "
        f"by applying the following transformation: <replace>. {_STEP_SUFFIX}",
        "Step 1. Objects: bench, car\nStep 2. Attribute Bindings: ['blue', 'bench'], "
        "['red', 'car']\nStep 3. Transformation: <replace>; Transformed Attributes: "
        "['white', 'bench'], ['green', 'car']\nStep 4. Contrastive Prompt: "
        "a white bench and a green car",
    ),
    (
        "a rubber tire and a wooden desk\nGenerate object-level contrastive prompts "
        f"by applying the following transformation: <swap>. {_STEP_SUFFIX}",
        "Step 1. Objects: tire, desk\nStep 2. Attribute Bindings: ['rubber', 'tire'], "
        "['wooden', 'desk']\nStep 3. Transformation: <swap>; Transformed Attributes: "
        "['wooden', 'tire'], ['rubber', 'desk']\nStep 4. Contrastive Prompt: "
        "a wooden tire and a rubber desk",
    ),
    (
        "a oblong sweet potato and teardrop mango\nGenerate object-level contrastive "
        "prompts by applying the following transformation: <drop>. Avoid changing the "
        f"original attribute bindings of the objects that are not dropped. {_STEP_SUFFIX}",
        "Step 1. Objects: sweet potato, mango\nStep 2. Attributes Bindings: "
        "['oblong', 'sweet potato'], ['teardrop', 'mango']\nStep 3. Transformation: "
        "<drop>; Transformed Attributes: ['teardrop', 'mango']\nStep 4. "
        "Contrastive Prompt: a teardrop mango",
    ),
)


def attribute_negative(p_type: str, question: str):
    assert p_type in ("replace", "swap", "drop"), f"Invalid perturbation type: {p_type}"
    if p_type == "drop":
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            "following transformation: <drop>. Avoid changing the original attribute "
            f"bindings of the objects that are not dropped. {_STEP_SUFFIX}"
        )
    else:
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            f"following transformation: <{p_type}>. {_STEP_SUFFIX}"
        )
    return _ATTR_SYSTEM, _turns(_ATTR_EXEMPLARS, final)


# --------------------------------------------------------------------------
# spatial (layout1)
# --------------------------------------------------------------------------

_SPATIAL_SYSTEM = (
    _FOUR_STEP_HEADER
    + "Step 1. Identify all objects in the prompt."
    + "Step 2. Identify all object-attribute bindings in the prompt."
    + "Step 3. Apply one of the following transformations to the given prompt: "
    "(1) <replace> a spatial relationship with another plausible one, "
    "(2) <swap> two objects placed side by side in the spatial layout, or "
    "(3) <drop> a spatial relationship."
    + "Step 4. Generate contrastive prompts based on the transformations."
    + "Always ensure the output has opposing or conflicting semantics compared "
    "to the input. Do not just reorder or repeat the input."
)

_SPATIAL_WORDS = ["under", "next to", "in front of", "behind",
                  "to the left of", "to the right of"]


def spatial_negative(p_type: str, question: str):
    assert p_type in ("replace", "swap", "drop"), f"Invalid perturbation type: {p_type}"
    selected = random.choice(_SPATIAL_WORDS)  # anti-overfitting randomisation

    exemplars = (
        (
            "A xylophone above a computer\nGenerate object-level contrastive prompts "
            f"by applying the following transformation: <replace>. {_STEP_SUFFIX}",
            "Step 1. Objects: xylophone, computer\nStep 2. Attribute Bindings: "
            "['xylophone', 'above', 'computer']\nStep 3. Transformation: <replace>; "
            f"Transformed Attributes: ['xylophone', '{selected}', 'computer']\n"
            f"Step 4. Contrastive Prompt: A xylophone {selected} a computer",
        ),
        (
            "A ramen bowl to the right of a coffee cup\nGenerate object-level "
            "contrastive prompts by applying the following transformation: <swap>. "
            f"{_STEP_SUFFIX}",
            "Step 1. Objects: ramen bowl, coffee cup\nStep 2. Attribute Bindings: "
            "['ramen bowl', 'the right of', 'coffee cup']\nStep 3. Transformation: "
            "<swap>; Transformed Attributes: ['coffee cup', 'the right of', "
            "'ramen bowl']\nStep 4. Contrastive Prompt: A coffee cup to the right "
            "of a ramen bowl",
        ),
        (
            "A microwave oven next to a sweatshirt\nGenerate object-level contrastive "
            f"prompts by applying the following transformation: <drop>. {_STEP_SUFFIX}",
            "Step 1. Objects: microwave oven, sweatshirt\nStep 2. Attributes Bindings: "
            "['microwave oven', 'next to', 'sweatshirt']\nStep 3. Transformation: "
            "<drop>; Transformed Attributes: ['microwave oven', 'sweatshirt']\n"
            "Step 4. Contrastive Prompt: A microwave oven and a sweatshirt",
        ),
    )

    if p_type == "replace":
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            f"following transformation: <replace>. Avoid just using '{selected}' in "
            f"the example. {_STEP_SUFFIX}"
        )
    else:
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            f"following transformation: <{p_type}>. {_STEP_SUFFIX}"
        )
    return _SPATIAL_SYSTEM, _turns(exemplars, final)


# --------------------------------------------------------------------------
# numeracy (layout2, layout3)
# --------------------------------------------------------------------------

_NUMERACY_SYSTEM = (
    _FOUR_STEP_HEADER
    + "Step 1. Identify all objects in the prompt."
    + "Step 2. Identify all object-number bindings in the prompt."
    + "Step 3. Apply one of the following transformations to the given prompt: "
    "(1) <replace> a number with another plausible one, (2) <swap> two numbers, "
    "or (3) <drop> a number or object."
    + "Step 4. Generate contrastive prompts based on the transformations from Step 3."
    + "Always ensure the output has opposing or conflicting semantics compared "
    "to the input."
)

_NUMERACY_EXEMPLARS = (
    (
        "Three coffee cups and four telephones\nGenerate object-level contrastive "
        "prompts by applying the following transformation: <replace>. Replace the "
        f"number with new one. Avoid answering the original input at Step 4. {_STEP_SUFFIX}",
        "Step 1. Objects: coffe cups, telephones\nStep 2. Number Bindings: "
        "['three', 'coffee cups'], ['four', 'telephones']\nStep 3. Transformation: "
        "<replace>; Transformed Bindings: ['two', 'coffee cups'], ['six', 'telephones']"
        "\nStep 4. Contrastive Prompt: two coffee cups and six telephones",
    ),
    (
        "A desk and five rugs\nGenerate object-level contrastive prompts by applying "
        f"the following transformation: <swap>. Avoid answering the original input at Step 4. {_STEP_SUFFIX}",
        "Step 1. Objects: desk, rugs\nStep 2. Number Bindings: ['one', 'desk'], "
        "['five', 'rugs']\nStep 3. Transformation: <swap>; Transformed Bindings: "
        "['five', 'desk'], ['one', 'rugs']\nStep 4. Contrastive Prompt: "
        "five desks and one rug",
    ),
    (
        "Two apples and a blouse\nGenerate object-level contrastive prompts by "
        f"applying the following transformation: <drop>. Avoid answering the original input at Step 4. {_STEP_SUFFIX}",
        "Step 1. Objects: apples, blouse\nStep 2. Number Bindings: ['two', 'apples'], "
        "['one', 'blouse']\nStep 3. Transformation: <drop>; Transformed Bindings: "
        "['two', 'apples']\nStep 4. Contrastive Prompt: two apples",
    ),
)


def numeracy_negative(p_type: str, question: str):
    assert p_type in ("replace", "swap", "drop"), f"Invalid perturbation type: {p_type}"
    if p_type == "replace":
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            "following transformation: <replace>. Replace the number with new one. "
            f"Avoid answering the original input at Step 4. {_STEP_SUFFIX}"
        )
    else:
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            f"following transformation: <{p_type}>. Avoid answering the original "
            f"input at Step 4. {_STEP_SUFFIX}"
        )
    return _NUMERACY_SYSTEM, _turns(_NUMERACY_EXEMPLARS, final)


# --------------------------------------------------------------------------
# non-spatial
# --------------------------------------------------------------------------

_NS_REPLACE_SYSTEM = (
    _FOUR_STEP_HEADER
    + "Step 1. Identify all subjects in the prompt."
    + "Step 2. Identify all subject-action or subject-action-object/complement bindings."
    + "Step 3. Apply the following transformations to the prompt: <replace> an "
    "action, object, or complement with another plausible but semantically distinct one."
    + "Step 4. Generate a contrastive prompt using the transformed bindings."
    + "Always ensure the output has opposing or conflicting semantics compared "
    "to the input. Avoid just reordering or repeating the input."
)

_NS_REPLACE_SUFFIX = (
    "\nGenerate object-level contrastive prompts by applying the following "
    "transformation: <replace>. Do not reuse the same actions, verbs, or "
    f"semantics. {_STEP_SUFFIX}"
)

_NS_REPLACE_EXEMPLARS = (
    (
        "a couple is having a loud arguments while watching baseball in the backyard."
        + _NS_REPLACE_SUFFIX,
        "Step 1. Subjects: a couple\nStep 2. Action Bindings: ['a couple', 'is having', "
        "'a loud arguments'], ['a couple', 'is watching', 'baseball', 'in the backyard.']"
        "\nStep 3. Transformation: <replace>; Transformed Actions: ['a couple', "
        "'is speaking', 'a loud arguments'], ['a couple', 'is playing', 'baseball', "
        "'in the backyard.']\nStep 4. Contrastive Prompt: a couple is speaking a loud "
        "arguments while playing baseball in the backyard.",
    ),
    (
        "a grandfather shares a funny story with his grandson while sitting on the sofa."
        + _NS_REPLACE_SUFFIX,
        "Step 1. Subjects: a grandfather, his grandson\nStep 2. Action Bindings: "
        "['a grandfather', 'shares', 'a funny story'], ['grandson', 'is sitting', "
        "'on the sofa']\nStep 3. Transformation: <replace>; Transformed Actions: "
        "['a grandfather', 'reads', 'a funny story'], ['grandson', 'is jumping', "
        "'on the sofa']\nStep 4. Contrastive Prompt: A grandfather reads a funny "
        "story with his grandson while jumping on the sofa.",
    ),
    (
        "a teacher is having a conversation with two students about their report cards."
        + _NS_REPLACE_SUFFIX,
        "Step 1. Subjects: a teacher\nStep 2. Action Bindings: ['a teacher', "
        "'is having', 'a conversation' 'with two students']\nStep 3. Transformation: "
        "<replace>; Transformed Actions: ['a teacher', 'is grading', 'assignments' "
        "'with two students']\nStep 4. Contrastive Prompt: a teacher is grading "
        "assignments with two students about their report cards.",
    ),
)

_NS_DROP_SYSTEM = (
    "You are a helpful assistant that generates object-level contrastive prompts "
    "by applying the <drop> transformation.\n\nYou must follow these steps:\n"
    "Step 1. Identify all objects in the prompt."
    "Step 2. Randomly select one of the objects from Step 1."
    "Step 3. Mark the selected object with the tag <pos> in the original prompt."
    "Step 4. Remove the <pos>-tagged object entirely from the prompt to generate "
    "the contrastive output."
    "Avoid just repeating the input and ensure that the ouput has less specific "
    "information than input."
)

_NS_DROP_SUFFIX = (
    "\nGenerate object-level contrastive prompts by applying the following "
    f"transformation: <drop>. {_STEP_SUFFIX} Avoid including selected object "
    "in the output."
)

_NS_DROP_EXEMPLARS = (
    (
        "a couple is having a loud arguments while watching baseball in the backyard."
        + _NS_DROP_SUFFIX,
        "Step 1. Objects: ['arguments', 'baseball', 'backyard']\nStep 2. Selected "
        "Object: ['backyard']\nStep 3. a couple is having a loud arguments while "
        "watching baseball in the <pos>.\nStep 4.Contrastive Prompt: a couple is "
        "having a loud arguments while watching baseball in the.",
    ),
    (
        "a grandfather shares a funny story with his grandson while sitting on the sofa."
        + _NS_DROP_SUFFIX,
        "Step 1. Objects: ['story', 'sofa']\nStep 2. Selected Object: ['story']\n"
        "Step 3. a grandfather shares a funny <pos> with his grandson while sitting "
        "on the sofa.\nStep 4.Contrastive Prompt: a grandfather shares a funny with "
        "his grandson while sitting on the sofa.",
    ),
    (
        "a person is writing a recipe down with a tablet while sitting on the couch."
        + _NS_DROP_SUFFIX,
        "Step 1. Objects: ['recipe', 'tablet', 'couch']\nStep 2. Selected Object: "
        "['tablet']\nStep 3. a person is writing a recipe down with a <pos> while "
        "sitting on the couch.\nStep 4.Contrastive Prompt: a person is writing a "
        "recipe down with a while sitting on the couch.",
    ),
)


def non_spatial_negative(p_type: str, question: str):
    assert p_type in ("replace", "swap", "drop"), f"Invalid perturbation type: {p_type}"
    if p_type == "replace":
        return _NS_REPLACE_SYSTEM, _turns(
            _NS_REPLACE_EXEMPLARS, question + _NS_REPLACE_SUFFIX
        )
    if p_type == "drop":
        return _NS_DROP_SYSTEM, _turns(_NS_DROP_EXEMPLARS, question + _NS_DROP_SUFFIX)
    return None, None  # <swap> unsupported for non-spatial (reference parity)


# --------------------------------------------------------------------------
# complex
# --------------------------------------------------------------------------

_COMPLEX_SYSTEM = (
    _FOUR_STEP_HEADER
    + "Step 1. Identify all objects in the prompt."
    + "Step 2. Identify all object-attribute bindings in the prompt."
    + "Step 3. Apply one of the following transformations to the given prompt: "
    "(1) <replace> an attribute with another plausible one, (2) <swap> two "
    "attributes or objects, or (3) <drop> an attribute or object."
    + "Step 4. Generate contrastive prompts based on the transformations."
    + "Always ensure the output has opposing or conflicting semantics compared "
    "to the input."
)

_COMPLEX_EXEMPLARS = (
    (
        "the gleaming silver, spiral staircase connected every floor, its majestic "
        "curves wrapping around the living room like a graceful, snake-like vine.\n"
        "Generate object-level contrastive prompts by applying the following "
        f"transformation: <swap>. {_STEP_SUFFIX}",
        "Step 1. Objects: staircase, floor, curves, living room, vine\nStep 2. "
        "Attribute Bindings: staircase-['gleaming', 'silver', 'spiral']; "
        "curves-['majestic']; vine-['graceful', 'snake-like']\nStep 3. Transformation: "
        "<swap>; Transformed Attributes: staircase-['graceful', 'snake-like']; "
        "curves-['majestic']; vine-['gleaming', 'silver', 'spiral']\nStep 4. "
        "Contrastive Prompt: the graceful, snake-like staircase connected every "
        "floor, its majestic curves wrapping around the living room like a gleaming "
        "silver, spiral vine.",
    ),
    (
        "the tall, slender white tent stood out next to the thick, broad, tan tree.\n"
        "Generate object-level contrastive prompts by applying the following "
        f"transformation: <replace>. {_STEP_SUFFIX}",
        "Step 1. Objects: tent, tree\nStep 2. Attribute Bindings: tent-['tall', "
        "'slender', 'white']; tree-['thick', 'broad', 'tan']\nStep 3. Transformation: "
        "<replace>; Transformed Attributes: tent-['small', 'slender', 'white']; "
        "tree-['thick', 'broad', 'yellow']\nStep 4. Contrastive Prompt: the small, "
        "slender white tent stood out next to the thick, broad, yellow tree.",
    ),
    (
        "the turquoise fish darted gracefully beside the green, moss-covered lily "
        "pads floating on calm reflective waters.\nGenerate object-level contrastive "
        "prompts by applying the following transformation: <drop>. Avoid changing "
        f"the original attribute bindings of the objects that are not dropped. {_STEP_SUFFIX}",
        "Step 1. Objects: fish, pads, waters\nStep 2. Attributes Bindings: "
        "fish-['turquoise']; pads-['green', 'moss-covered', 'lily']; waters-['calm', "
        "'reflective']\nStep 3. Transformation: <drop>; Transformed Attributes: "
        "pads-['green', 'moss-covered', 'lily']; waters-['calm', 'reflective']\n"
        "Step 4. Contrastive Prompt: the green, moss-covered lily pads floating on "
        "calm reflective waters.",
    ),
)


def complex_negative(p_type: str, question: str):
    assert p_type in ("replace", "swap", "drop"), f"Invalid perturbation type: {p_type}"
    if p_type == "drop":
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            "following transformation: <drop>. Avoid changing the original attribute "
            f"bindings of the objects that are not dropped. {_STEP_SUFFIX}"
        )
    else:
        final = (
            f"{question}\nGenerate object-level contrastive prompts by applying the "
            f"following transformation: <{p_type}>. {_STEP_SUFFIX}"
        )
    return _COMPLEX_SYSTEM, _turns(_COMPLEX_EXEMPLARS, final)


# sub_category → builder (template_negative.py:236-246)
NEGATIVE_TEMPLATES = {
    "attribute1_color": attribute_negative,
    "attribute1_texture": attribute_negative,
    "attribute1_shape": attribute_negative,
    "attribute2": attribute_negative,
    "layout1": spatial_negative,
    "layout2": numeracy_negative,
    "layout3": numeracy_negative,
    "non-spatial": non_spatial_negative,
    "complex": complex_negative,
}


def get_negative_conversation(sub_category: str, p_type: str, prompt: str):
    return NEGATIVE_TEMPLATES[sub_category](p_type, prompt)

"""Step-4a question-decomposition templates.

Prompt text preserved from ``ospo/templates/template_vqa.py:1-101``; the
model output is parsed downstream on the "Questions: " anchor and split
on '?'.
"""

from __future__ import annotations

from ospo_tpu_torch.pipeline.templates.base import FewShotTemplate

_VQA_SYSTEM = (
    "You are an assistant dedicated to transforming a sentence into several "
    "questions. You should first divide it into simple concepts and relations, "
    "and then provide the corresponding questions. Avoid using pronouns, such "
    "as he, she, it, and they."
)

VQA_TEMPLATES = {
    "attribute": FewShotTemplate(
        system=_VQA_SYSTEM,
        exemplars=(
            (
                "A white harp and a rust soup.",
                "Concepts and relations: a white harp, a rust soup; Questions: "
                "Is there a white harp? Is there a rust soup?",
            ),
            (
                "A quarter circle lily and a hexagon mirror.",
                "Concepts and relations: a quarter circle lily, a hexagon mirror; "
                "Questions: Is there a quarter-circle lily? Is there a hexagon mirror?",
            ),
            (
                "Shiny mop and metal key holder.",
                "Concepts and relations: a shiny mop, a metal key holder; Questions: "
                "Is there a shiny mop? Is there a metal key holder?",
            ),
        ),
    ),
    "layout": FewShotTemplate(
        system=_VQA_SYSTEM,
        exemplars=(
            (
                "A pancake on the left of a pasta.",
                "Concepts and relations: a pancake, a pasta, a pancake is on the "
                "left of a pasta; Questions: Is there a pancake? Is there a pasta? "
                "Is a pancake on the left of a pasta?",
            ),
            (
                "A lamp behind a screwdriver.",
                "Concepts and relations: a lamp, a screwdriver, a lamp is behind a "
                "screwdriver; Questions: Is there a lamp? Is there a screwdriver? "
                "Is a lamp behind a screwdriver?",
            ),
            (
                "Three light bulbs and eight pumpkins.",
                "Concepts and relations: three light bulbs, eight pumpkins; "
                "Questions: Are there three light bulbs? Are there eight pumpkins?",
            ),
        ),
    ),
    "non-spatial": FewShotTemplate(
        system=_VQA_SYSTEM,
        exemplars=(
            (
                "A chef is holding a knife and preparing a dish on the stove.",
                "Concepts and relations: a chef, a knife, a dish, the stove, a chef "
                "is holding a knife, a chef is preparing a dish; Questions: Is there "
                "a chef? Is there a knife? Is there a dish? Is there a stove? Is a "
                "chef holding a knife? Is a chef preparing a dish?",
            ),
            (
                "The green teapot is located near the round oak table.",
                "Concepts and relations: a green teapot, a round oak table, the "
                "green teapot is near the round oak table, the round oak table is "
                "near the green teapot; Questions: Is there a green teapot? Is there "
                "a round oak table? Is the green teapot near the round oak table? "
                "Is the round oak table near the green teapot?",
            ),
            (
                "The chunky wooden lamp casts a warm glow on the tattered blue curtains.",
                "Concepts and relations: a chunky wooden lamp, a warm glow, tattered "
                "blue curtains, a chunky wooden lamp casts a warm glow, the warm "
                "glow is on the tattered blue curtains; Questions: Is there a chunky "
                "wooden lamp? Is there a warm glow? Are there tattered blue "
                "curtains? Is a chunky wooden lamp casting a warm glow? Is the warm "
                "glow on the tattered blue curtains?",
            ),
            (
                "The vibrant orange tomato sat atop the crisp green leaf and the "
                "juicy red watermelon.",
                "Concepts and relations: a vibrant orange tomato, a crisp green "
                "leaf, a juicy red watermelon, a vibrant orange tomato is atop a "
                "crisp green leaf, a vibrant orange tomato is atop a juicy red "
                "watermelon; Questions: Is there a vibrant orange tomato? Is there "
                "a crisp green leaf? Is there a juicy red watermelon? Is the vibrant "
                "orange tomato atop the crisp green leaf? Is the vibrant orange "
                "tomato atop the juicy red watermelon?",
            ),
        ),
    ),
}
VQA_TEMPLATES["complex"] = VQA_TEMPLATES["non-spatial"]


def get_vqa_conversation(category: str, prompt: str):
    """→ (system_prompt, conversation) — query turn is the raw prompt."""
    return VQA_TEMPLATES[category].conversation(prompt)

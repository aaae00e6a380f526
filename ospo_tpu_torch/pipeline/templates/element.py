"""Step-1 element / base-prompt generation templates.

Prompt text preserved from ``ospo/templates/template_element.py:2-184``
(it is the pipeline's data protocol); organised as exemplar tables.
"""

from __future__ import annotations

from ospo_tpu_torch.pipeline.templates.base import FewShotTemplate

_CATEGORY_SCOPE = (
    "spanning various categories, including animals, plants, fruits, "
    "household items, clothing, vehicles, food, musical instruments, and "
    "electronic devices."
)

_OBJECT_Q = "Generate common objects spanning various categories."
_COLOR_Q = (
    "Generate common colors spanning various categories.\n"
    "Output only simple color names (e.g., red, blue, gray). "
    "Avoid compound colors (e.g., dark gray, light blue)."
)
_TEXTURE_Q = (
    "Generate common texture spanning various categories.\nAvoid compound texture."
)
_SHAPE_Q = (
    "Generate common shape spanning various categories.\nAvoid compound shape."
    "\nAvoid object names like car, house..."
)
_SPATIAL_Q = (
    "Generate common spatial relative word or phrase spanning various "
    "categories.\nAvoid compound spatial relative word."
)
_NON_SPATIAL_Q = (
    "Generate a prompt that contains subjects and objects by using "
    "non-spatial relationship words."
)
_COMPLEX_Q = (
    "Please generate a compositional phrase or sentence containing multiple "
    "objects with one or several adjectives and relationships."
)


ELEMENT_TEMPLATES = {
    "object": FewShotTemplate(
        system="You are a helpful assistant that generates common object " + _CATEGORY_SCOPE,
        exemplars=(
            (_OBJECT_Q, "dog, rose, apple, chair, shirt, car, pizza, guitar, cell phone"),
            (_OBJECT_Q, "cat, cactus, banana, sofa, jacket, bicycle, sushi, piano, laptop"),
        ),
        query=lambda: _OBJECT_Q,
    ),
    "color": FewShotTemplate(
        system="You are a helpful assistant that generates common colors " + _CATEGORY_SCOPE,
        exemplars=(
            (_COLOR_Q, "red, blue, green, yellow, black, white, orange, pink, purple, brown"),
            (_COLOR_Q, "cyan, magenta, lime, indigo, teal, navy, beige, maroon, olive, gold"),
        ),
        query=lambda: _COLOR_Q,
    ),
    "texture": FewShotTemplate(
        system="You are a helpful assistant that generates common texture " + _CATEGORY_SCOPE,
        exemplars=(
            (_TEXTURE_Q, "rubber, metallic, leather, fabric, wooden, rough, smooth, soft, fluffy, glass"),
            (_TEXTURE_Q, "gritty, silky, woolly, grainy, velvety, bumpy, slick, crinkled, coarse, porous"),
        ),
        query=lambda: _TEXTURE_Q,
    ),
    "shape": FewShotTemplate(
        system=(
            "You are a helpful assistant that generates common shape "
            + _CATEGORY_SCOPE
            + "\nAvoid containing objects names in the output."
        ),
        exemplars=(
            (_SHAPE_Q, "diamond, square, pyramidal, triangular, rectangular, oval, short, teardrop, cubic, oblong"),
            (_SHAPE_Q, "circular, small, spherical, conical, cylindrical, heart, big, spiral, tall"),
        ),
        query=lambda: _SHAPE_Q,
    ),
    "spatial": FewShotTemplate(
        system=(
            "You are a helpful assistant that generates common spatial relative "
            "word or phrase " + _CATEGORY_SCOPE
            + "\nContain only one spatial relative phrase."
            + "\nAvoid compound spatial relative word such as farther up for "
            "the right of, closer down for the left of, etc."
            + "\nAvoid containing objects names such as image, window, screen, "
            "etc. in the output."
        ),
        exemplars=(
            (_SPATIAL_Q, "in the left of, among, above, below, beside, opposite to, next to, above of, below of, beside of"),
            (_SPATIAL_Q, "in the right of, in the middle of, in front of, hidden by, top of, next to"),
        ),
        query=lambda: _SPATIAL_Q,
    ),
    "non-spatial": FewShotTemplate(
        system=(
            "You are an assistant dedicated to generating natural prompts that "
            "contain subjects and objects by using nonspatial relationship "
            "words such as wear, watch, speak, hold, have, run, look at, talk "
            "to, jump, play, walk with, stand on, and sit on."
        ),
        exemplars=(
            (_NON_SPATIAL_Q, "Two friends are watching a movie together on a large TV screen."),
            (_NON_SPATIAL_Q, "Two athletes are running along the beach as the sun sets behind them."),
        ),
        query=lambda: _NON_SPATIAL_Q,
    ),
    "complex": FewShotTemplate(
        system=(
            "You are an assistant dedicated to generating natural compositional "
            "phrases or prompts, containing multiple objects (number ≥ 2) with "
            "one or several adjectives from color, shape, and texture "
            "descriptions and spatial (left/right/top/bottom/next to/near/on "
            "side of) or nonspatial relationships."
        ),
        exemplars=(
            (_COMPLEX_Q, "The fluffy white cat sat next to the black leather couch."),
            (_COMPLEX_Q, "The sleek black phone rested beside the textured brown leather wallet."),
            (_COMPLEX_Q, "The red spherical balloon floated above the striped rectangular kite and the green triangular flag."),
            (_COMPLEX_Q, "The golden, sunlit leaves floated softly above the jagged, rust-colored rocks, their delicate, lacy shapes casting playful shadows on the uneven ground."),
        ),
        query=lambda: _COMPLEX_Q,
    ),
}


def get_element_conversation(category: str):
    """→ (system_prompt, conversation) for a step-1 category."""
    return ELEMENT_TEMPLATES[category].conversation()

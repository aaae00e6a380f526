"""Tiny English number-word / pluralisation helpers.

Replaces the reference's ``inflect`` dependency (ospo/step1.py:6,38,74-92)
for the two operations the pipeline needs: spelling out small counts
(layout2 goes up to 29, layout3 up to 5) and pluralising object nouns.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]

_IRREGULAR_PLURALS = {
    "man": "men", "woman": "women", "child": "children", "person": "people",
    "foot": "feet", "tooth": "teeth", "goose": "geese", "mouse": "mice",
    "ox": "oxen", "sheep": "sheep", "deer": "deer", "fish": "fish",
    "leaf": "leaves", "knife": "knives", "wife": "wives", "life": "lives",
    "loaf": "loaves", "shelf": "shelves", "wolf": "wolves", "calf": "calves",
    "half": "halves", "scarf": "scarves", "thief": "thieves",
    "cactus": "cacti", "die": "dice",
}

_VOWELS = "aeiou"


def number_to_words(n: int) -> str:
    """Spell out 0..99 ('twenty-nine' style, matching inflect)."""
    if n < 0 or n > 99:
        raise ValueError(f"unsupported number: {n}")
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + (f"-{_ONES[ones]}" if ones else "")


def plural(noun: str) -> str:
    """Pluralise a (possibly multi-word) noun phrase — the last word carries
    the plural, like inflect's ``p.plural``."""
    noun = noun.strip()
    if not noun:
        return noun
    head, _, last = noun.rpartition(" ")
    low = last.lower()
    if low in _IRREGULAR_PLURALS:
        out = _IRREGULAR_PLURALS[low]
        if last[0].isupper():
            out = out.capitalize()
    elif low.endswith(("s", "x", "z", "ch", "sh")):
        out = last + "es"
    elif low.endswith("y") and len(low) > 1 and low[-2] not in _VOWELS:
        out = last[:-1] + "ies"
    elif low.endswith("o") and len(low) > 1 and low[-2] not in _VOWELS and low not in (
        "photo", "piano", "halo", "pro", "avocado", "taco", "logo", "kimono",
    ):
        out = last + "es"
    elif low.endswith("fe"):
        out = last[:-2] + "ves"
    else:
        out = last + "s"
    return f"{head} {out}" if head else out

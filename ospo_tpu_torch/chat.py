"""DeepSeek chat template (the one the OSPO pipeline uses) — copy of the
template part of ``ospo_tpu/chat.py`` (``janus/utils/conversation.py``),
rendered as::

    {system}\n\n<|User|>: {msg}\n\n<|Assistant|>:{answer}<｜end▁of▁sentence｜>

with the system block omitted when the system message is empty.  The other
registry styles come with the slices that use them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ospo_tpu_torch.constants import EOS_TAG

# the system prompt of the understanding conversations
# (``processing_vlm.py``'s default, ``ospo_tpu/chat.py:21-25``)
DEFAULT_SYSTEM_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)

SEP = "\n\n"
SEP2 = EOS_TAG


def render(messages: Sequence[Tuple[str, str]], system_prompt: str = "") -> str:
    """Render (role, content) turns; empty content leaves an open turn
    (``"<|Assistant|>:"``).  Roles are rendered verbatim, as the reference
    does (step-3 prompts read "User: ...")."""
    parts: List[str] = []
    if system_prompt:
        parts.append(system_prompt + SEP)
    seps = (SEP, SEP2)
    for i, (role, message) in enumerate(messages):
        parts.append(f"{role}: {message}{seps[i % 2]}" if message
                     else f"{role}:")
    return "".join(parts)


def apply_sft_template(conversations: Sequence[Dict[str, str]],
                       system_prompt: str = "") -> str:
    """Conversation (``{"role", "content"}`` dicts) → stripped SFT prompt
    (``processing_vlm.py:137-177``)."""
    msgs = [(m["role"], m["content"].strip()) for m in conversations]
    return render(msgs, system_prompt).strip()


def t2i_conversation(prompt: str) -> List[Dict[str, str]]:
    """Single-turn text-to-image conversation with the reference's bare
    "User"/"Assistant" roles (``ospo/utils/processor.py:8-17``)."""
    return [
        {"role": "User", "content": prompt},
        {"role": "Assistant", "content": ""},
    ]

"""Few-shot CoT prompt templates as structured data.

The reference builds each prompt family as a bespoke function returning a
(system_prompt, conversation) pair (``ospo/templates/*.py``).  Here the
exemplars are data: a :class:`FewShotTemplate` holds the system prompt, the
(user, assistant) exemplar pairs, and a query formatter; ``conversation()``
renders the reference-identical message list (exemplars + open final turn).
The prompt *text* is part of the pipeline's data protocol and is preserved
verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

Message = Dict[str, str]
Conversation = List[Message]

USER = "<|User|>"
ASSISTANT = "<|Assistant|>"


@dataclasses.dataclass(frozen=True)
class FewShotTemplate:
    system: str
    exemplars: Tuple[Tuple[str, str], ...]
    # formats the final user turn from the caller's query args
    query: Callable[..., str] = lambda q: q

    def conversation(self, *args, **kwargs) -> Tuple[str, Conversation]:
        msgs: Conversation = []
        for user, assistant in self.exemplars:
            msgs.append({"role": USER, "content": user})
            msgs.append({"role": ASSISTANT, "content": assistant})
        msgs.append({"role": USER, "content": self.query(*args, **kwargs)})
        msgs.append({"role": ASSISTANT, "content": ""})
        return self.system, msgs

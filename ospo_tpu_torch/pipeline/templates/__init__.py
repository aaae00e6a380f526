from ospo_tpu_torch.pipeline.templates.dense import (  # noqa: F401
    DENSE_TEMPLATES,
    get_dense_conversation,
)
from ospo_tpu_torch.pipeline.templates.element import (  # noqa: F401
    ELEMENT_TEMPLATES,
    get_element_conversation,
)
from ospo_tpu_torch.pipeline.templates.negative import (  # noqa: F401
    NEGATIVE_TEMPLATES,
    get_negative_conversation,
)
from ospo_tpu_torch.pipeline.templates.vqa import (  # noqa: F401
    VQA_TEMPLATES,
    get_vqa_conversation,
)

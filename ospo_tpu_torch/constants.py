"""Pipeline-wide constants.

Parity notes: values mirror the reference protocol constants at
``ospo/constant.py:1-4`` (IMG_SIZE=384, PATCH_SIZE=16, PARALLEL_SIZE=1,
IMAGE_TOKEN_NUM_PER_IMAGE=576) — 576 image tokens = (384/16)^2 VQ latents.
"""

IMG_SIZE = 384
PATCH_SIZE = 16
PARALLEL_SIZE = 1
IMAGE_TOKEN_NUM_PER_IMAGE = 576

# Special token surface forms of the Janus-Pro / DeepSeek tokenizer.
IMAGE_TAG = "<image_placeholder>"
IMAGE_START_TAG = "<begin_of_image>"
IMAGE_END_TAG = "<end_of_image>"
PAD_TAG = "<｜▁pad▁｜>"
BOS_TAG = "<｜begin▁of▁sentence｜>"
EOS_TAG = "<｜end▁of▁sentence｜>"

# Loss masking value used for labels that do not contribute to log-probs.
IGNORE_ID = -100

# The 7 step-1 prompt categories.
CATEGORIES = (
    "object",
    "color",
    "shape",
    "texture",
    "spatial",
    "non-spatial",
    "complex",
)

from .generation import sample_token
from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig, apply_rope

__all__ = ["GPT", "GPTConfig", "Llama", "LlamaConfig", "apply_rope",
           "sample_token"]

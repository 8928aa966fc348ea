from . import ernie, hf_compat, ocr  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama3_8b_config, llama3_70b_config, llama_tiny_config)
from .ssd import (SSDConfig, SSDForCausalLM, SSDModel, ssd_8b_config,  # noqa: F401
                  ssd_tiny_config, ssd_tiny_hybrid_config)
from .ernie import (ErnieConfig, ErnieForSequenceClassification, ErnieModel,  # noqa: F401
                    ernie_tiny_config)
from .hf_compat import (ernie_config_from_transformers, ernie_from_transformers,  # noqa: F401
                        ernie_to_transformers_state_dict, llama_config_from_transformers,
                        llama_from_transformers, llama_to_transformers_state_dict)
from .convert import (load_paddle_tpu_opt_state, load_paddle_tpu_params,  # noqa: F401
                      load_paddle_tpu_train_state, to_paddle_tpu_opt_state,
                      to_paddle_tpu_params, to_paddle_tpu_train_state)
from .cache_spec import llama_cache_spec  # noqa: F401

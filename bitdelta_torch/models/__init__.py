"""Model families. ``resolve_model_module(cfg)`` maps a config to its
decoder module (llama layout for Llama/Mistral/Qwen2; mixtral for MoE):
the one dispatch point the CLIs and serving share."""


def resolve_model_module(cfg):
    from .mixtral import MixtralConfig

    if isinstance(cfg, MixtralConfig):
        from . import mixtral

        return mixtral
    from . import llama

    return llama

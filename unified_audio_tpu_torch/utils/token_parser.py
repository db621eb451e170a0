"""Task and attribute token maps.

The port's own copy of ``unified_audio_tpu/utils/token_parser.py``: the
SparkTTS-era string maps the reference carries (task tokens, gender,
levels, emotions) and the ``<|bicodec_global_N|>`` /
``<|bicodec_semantic_N|>`` renderings of token sequences.
"""
from __future__ import annotations

from typing import Dict

TASK_TOKEN_MAP: Dict[str, str] = {
    "vc": "<|task_vc|>",
    "tts": "<|task_tts|>",
    "asr": "<|task_asr|>",
    "s2s": "<|task_s2s|>",
    "t2s": "<|task_t2s|>",
    "understand": "<|task_understand|>",
    "caption": "<|task_cap|>",
    "controllable_tts": "<|task_controllable_tts|>",
    "prompt_tts": "<|task_prompt_tts|>",
    "speech_edit": "<|task_edit|>",
    # UniSE / UniTok task names
    "se": "<|task_se|>",
    "tse": "<|task_tse|>",
    "rtse": "<|task_rtse|>",
    "ss": "<|task_ss|>",
    "sr": "<|task_sr|>",
    "lass": "<|task_lass|>",
    "codec": "<|task_codec|>",
    "ae": "<|task_ae|>",
}

GENDER_MAP: Dict[str, int] = {"female": 0, "male": 1}

LEVELS_MAP: Dict[str, int] = {
    "very_low": 0, "low": 1, "moderate": 2, "high": 3, "very_high": 4,
}

EMO_MAP: Dict[str, int] = {
    "UNKNOWN": 0, "NEUTRAL": 1, "ANGRY": 2, "HAPPY": 3, "SAD": 4,
    "FEARFUL": 5, "DISGUSTED": 6, "SURPRISED": 7, "SARCASTIC": 8,
    "EXCITED": 9, "SLEEPY": 10, "CONFUSED": 11, "EMPHASIS": 12,
    "LAUGHING": 13, "SINGING": 14, "WORRIED": 15, "WHISPER": 16,
    "ANXIOUS": 17, "NO-AGREEMENT": 18, "APOLOGETIC": 19, "CONCERNED": 20,
    "ENUNCIATED": 21, "ASSERTIVE": 22, "ENCOURAGING": 23, "CONTEMPT": 24,
}


def global_token_string(tokens) -> str:
    """Global tokens as ``<|bicodec_global_N|>`` strings, concatenated."""
    return "".join(f"<|bicodec_global_{int(t)}|>" for t in tokens)


def semantic_token_string(tokens) -> str:
    """Semantic tokens as ``<|bicodec_semantic_N|>`` strings,
    concatenated."""
    return "".join(f"<|bicodec_semantic_{int(t)}|>" for t in tokens)

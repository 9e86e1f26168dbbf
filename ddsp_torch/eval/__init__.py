"""Evaluation: metrics, evaluators, summaries, heuristics, postprocessing,
plotting and the eval loop (port of ddsp_tpu.eval)."""

from ddsp_torch.eval import eval_util  # noqa: F401
from ddsp_torch.eval import heuristics  # noqa: F401
from ddsp_torch.eval import metrics  # noqa: F401
from ddsp_torch.eval import postprocessing  # noqa: F401
from ddsp_torch.eval import summaries  # noqa: F401
from ddsp_torch.eval.eval_util import evaluate_or_sample  # noqa: F401
from ddsp_torch.eval.evaluators import BaseEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import BasicEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import F0LdEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import MidiAutoencoderEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import MidiHeuristicEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import TWMEvaluator  # noqa: F401
from ddsp_torch.eval import plotting  # noqa: F401

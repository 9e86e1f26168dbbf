"""Evaluation: metrics, evaluators, summaries, postprocessing and the eval
loop (port of ddsp_tpu.eval, less what the MIDI models need: heuristics,
the MIDI metrics and evaluators, and the plots)."""

from ddsp_torch.eval import eval_util  # noqa: F401
from ddsp_torch.eval import metrics  # noqa: F401
from ddsp_torch.eval import postprocessing  # noqa: F401
from ddsp_torch.eval import summaries  # noqa: F401
from ddsp_torch.eval.eval_util import evaluate_or_sample  # noqa: F401
from ddsp_torch.eval.evaluators import BaseEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import BasicEvaluator  # noqa: F401
from ddsp_torch.eval.evaluators import F0LdEvaluator  # noqa: F401

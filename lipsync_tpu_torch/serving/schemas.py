"""Response contracts: the JAX package's ``serving/schemas.py`` (the
reference's pydantic models) as stdlib dataclasses.

The port imports no pydantic. :class:`Model` checks and converts each
field at construction for the values the routes give it (numbers, numpy
scalars, the verdict ``Literal``, nested dicts, the job store's ISO
strings), as pydantic v2's lax mode does for them, and raises
``ValueError`` where pydantic raises its ``ValidationError`` (a
``ValueError``), so the app answers 400 in the same cases. Strings are not
parsed into numbers or booleans. Nested models drop unknown keys, as
pydantic's default does. :meth:`Model.to_dict` is
``json.loads(model.model_dump_json())`` of the pydantic model: every field
in declaration order, ``None`` fields kept, NaN and infinities as ``None``,
a UTC ``datetime`` ending in ``Z``.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional


def _is_number(v) -> bool:
    return hasattr(v, "__float__") and not isinstance(v, (str, bytes))


def _coerce(value, tp, where: str):
    """``value`` validated against the annotation ``tp``: the rules that the
    predictor's result dicts, metric counts, job rows and settings need."""
    if typing.get_origin(tp) is typing.Union:  # Optional[X]
        if value is None:
            return None
        tp = next(a for a in typing.get_args(tp) if a is not type(None))
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is Any:
        return value
    if origin is Literal:
        if value not in args:
            raise ValueError(f"{where}: {value!r} is not one of {args}")
        return value
    if origin is list:
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: expected a list, got {value!r}")
        return [_coerce(v, args[0], f"{where}[{i}]")
                for i, v in enumerate(value)]
    if origin is dict:
        if not isinstance(value, dict):
            raise ValueError(f"{where}: expected a dict, got {value!r}")
        return {k: _coerce(v, args[1], f"{where}.{k}")
                for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, Model):
        if not isinstance(value, dict):
            raise ValueError(f"{where}: expected a {tp.__name__} object")
        return tp.parse(value)
    if tp in (bool, int, float):
        # Numbers only (numpy scalars included); an int or bool field takes
        # an integral value, a bool field 0 or 1, as pydantic's lax mode.
        f = float(value) if _is_number(value) else math.nan
        if tp is float and _is_number(value):
            return f
        if tp is int and math.isfinite(f) and f == int(f):
            return int(f)
        if tp is bool and f in (0.0, 1.0):
            return bool(f)
        raise ValueError(f"{where}: {value!r} is not a valid {tp.__name__}")
    if tp is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: {value!r} is not a string")
        return value
    if tp is datetime:  # the job store's ISO strings
        try:
            return (value if isinstance(value, datetime)
                    else datetime.fromisoformat(value))
        except (TypeError, ValueError):
            raise ValueError(f"{where}: {value!r} is not a datetime") \
                from None
    if tp is Path:
        if isinstance(value, (str, Path)):
            return Path(value)
        raise ValueError(f"{where}: {value!r} is not a path")
    raise TypeError(f"{where}: no rule for {tp}")


def _jsonable(value):
    """What pydantic's JSON dump and ``json.loads`` make of ``value``."""
    if isinstance(value, Model):
        return value.to_dict()
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, datetime):
        text = value.isoformat()
        return text[:-6] + "Z" if text.endswith("+00:00") else text
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


class Model:
    """Base of the serving dataclasses (keyword-only, as pydantic models
    are): fields are validated and coerced in ``__post_init__`` from their
    annotations."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            setattr(self, f.name, _coerce(getattr(self, f.name),
                                          hints[f.name],
                                          f"{type(self).__name__}.{f.name}"))

    @classmethod
    def field_names(cls) -> List[str]:
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def parse(cls, data: Dict[str, Any]):
        """The model from a dict: unknown keys dropped, a missing required
        field a ``ValueError``."""
        kwargs = {k: v for k, v in data.items() if k in cls.field_names()}
        missing = [f.name for f in dataclasses.fields(cls)
                   if f.name not in kwargs
                   and f.default is dataclasses.MISSING
                   and f.default_factory is dataclasses.MISSING]
        if missing:
            raise ValueError(f"{cls.__name__}: missing fields {missing}")
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: _jsonable(getattr(self, f.name))
                for f in dataclasses.fields(self)}


VerdictType = Literal["real", "fake", "uncertain"]


@dataclasses.dataclass(kw_only=True)
class TrackResult(Model):
    track_id: int
    is_real: bool
    is_fake: bool
    confidence: float
    manipulation_probability: float
    raw_confidence: Optional[float] = None
    stability: Optional[float] = None
    hits: Optional[int] = None
    total_frames: Optional[int] = None
    speaking_activity: Optional[float] = None
    selection_score: Optional[float] = None
    window_confidences: Optional[List[float]] = None
    consecutive_miss_max: Optional[int] = None
    # Mean mouth box over the track in source pixels (x1, y1, x2, y2).
    bbox: Optional[List[float]] = None


@dataclasses.dataclass(kw_only=True)
class WindowResult(Model):
    window_index: int
    frame_start: int
    frame_end: int
    time_start_sec: Optional[float] = None
    time_end_sec: Optional[float] = None
    selected_track_id: int
    confidence: float
    is_real: bool
    is_fake: bool


@dataclasses.dataclass(kw_only=True)
class SpeakerSegment(Model):
    selected_track_id: int
    frame_start: int
    frame_end: int
    time_start_sec: Optional[float] = None
    time_end_sec: Optional[float] = None


@dataclasses.dataclass(kw_only=True)
class MouthMotionCheck(Model):
    check_result: str
    audio_energy: Optional[float] = None
    mouth_motion_energy: Optional[float] = None


@dataclasses.dataclass(kw_only=True)
class LipSyncResponse(Model):
    verdict: VerdictType
    is_real: bool
    is_fake: bool
    confidence: float
    manipulation_probability: float
    tracks: Optional[List[TrackResult]] = None
    selected_track_id: Optional[int] = None
    selection_uncertain: Optional[bool] = None
    selection_margin: Optional[float] = None
    confidence_margin_uncertain: Optional[bool] = None
    confidence_gap: Optional[float] = None
    turn_taking_detected: Optional[bool] = None
    speaker_case: Optional[str] = None
    speaking_tracks_count: Optional[int] = None
    speaking_real_count: Optional[int] = None
    speaking_fake_count: Optional[int] = None
    verdicts: Optional[Dict[str, bool]] = None
    window_results: Optional[List[WindowResult]] = None
    speaker_timeline: Optional[List[SpeakerSegment]] = None
    video_duration_sec: Optional[float] = None
    total_chunks_analyzed: Optional[int] = None
    mouth_motion_check: Optional[MouthMotionCheck] = None
    sparse_real_guard_applied: Optional[bool] = None
    mouth_motion_override_applied: Optional[bool] = None
    override_reason: Optional[str] = None
    temporal_confidence_drop: Optional[bool] = None
    temporal_drift: Optional[float] = None
    first_half_avg_confidence: Optional[float] = None
    second_half_avg_confidence: Optional[float] = None
    detail: Optional[str] = None

    @classmethod
    def from_result(cls, result: Dict[str, Any]) -> "LipSyncResponse":
        """Keeps the predictor result's known keys only."""
        return cls.parse(result)


@dataclasses.dataclass(kw_only=True)
class BatchEvaluateResponse(Model):
    precision: float
    recall: float
    f1: float
    accuracy: float
    tp: int
    tn: int
    fp: int
    fn: int
    total: int


@dataclasses.dataclass(kw_only=True)
class PredictJobCreateResponse(Model):
    job_id: str
    status: str
    created_at: datetime


@dataclasses.dataclass(kw_only=True)
class JobResultResponse(Model):
    job_id: str
    status: str
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None

"""Window descriptors used as stage params.

Port of flink_ml_tpu/common/window.py (the reference's common/window/
Windows.java, GlobalWindows, CountTumblingWindows and the event-time and
processing-time tumbling and session windows). A descriptor says which rows
a windowed computation runs over (`utils/datastream.window_all_and_process`,
AgglomerativeClustering): GlobalWindows the whole bounded input,
CountTumblingWindows full windows of a fixed count, the event-time windows
a `timestamp` column in milliseconds, the processing-time windows the
arrival of each batch. The JSON encoding keeps the reference's Java class
names, so a window saved by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass


class Windows:
    """Base window descriptor (common/window/Windows.java)."""

    def json_encode(self):
        raise NotImplementedError

    @staticmethod
    def json_decode(json_value):
        kind = json_value.get("class")
        for cls in (
            GlobalWindows,
            CountTumblingWindows,
            EventTimeTumblingWindows,
            ProcessingTimeTumblingWindows,
            EventTimeSessionWindows,
            ProcessingTimeSessionWindows,
        ):
            if kind in (cls.__name__, cls._java_name()):
                return cls._from_json(json_value)
        raise ValueError(f"Unknown windows descriptor {json_value!r}")

    @classmethod
    def _java_name(cls):
        return f"org.apache.flink.ml.common.window.{cls.__name__}"

    @classmethod
    def _from_json(cls, json_value):
        return cls()


@dataclass(frozen=True)
class GlobalWindows(Windows):
    """All input in one global window (common/window/GlobalWindows.java)."""

    def json_encode(self):
        return {"class": self._java_name()}


@dataclass(frozen=True)
class CountTumblingWindows(Windows):
    """Tumbling windows of a fixed record count
    (common/window/CountTumblingWindows.java)."""

    size: int = 1

    @staticmethod
    def of(size: int) -> "CountTumblingWindows":
        return CountTumblingWindows(int(size))

    def json_encode(self):
        return {"class": self._java_name(), "size": int(self.size)}

    @classmethod
    def _from_json(cls, json_value):
        return cls(int(json_value["size"]))


@dataclass(frozen=True)
class _TimeTumblingWindows(Windows):
    size_ms: int = 0

    @classmethod
    def of(cls, size_ms: int):
        return cls(int(size_ms))

    def json_encode(self):
        return {"class": self._java_name(), "size": int(self.size_ms)}

    @classmethod
    def _from_json(cls, json_value):
        return cls(int(json_value["size"]))


class EventTimeTumblingWindows(_TimeTumblingWindows):
    pass


class ProcessingTimeTumblingWindows(_TimeTumblingWindows):
    pass


@dataclass(frozen=True)
class _SessionWindows(Windows):
    gap_ms: int = 0

    @classmethod
    def with_gap(cls, gap_ms: int):
        return cls(int(gap_ms))

    def json_encode(self):
        return {"class": self._java_name(), "gap": int(self.gap_ms)}

    @classmethod
    def _from_json(cls, json_value):
        return cls(int(json_value["gap"]))


class EventTimeSessionWindows(_SessionWindows):
    pass


class ProcessingTimeSessionWindows(_SessionWindows):
    pass

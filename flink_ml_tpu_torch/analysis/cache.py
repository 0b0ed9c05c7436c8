"""The incremental lint's summary cache: call-graph state keyed by content.

Port of flink_ml_tpu/analysis/cache.py. The call graph
(`analysis/callgraph.py`) walks every function body of the package to
build its summaries, the main cost of a full lint. A summary is a pure
function of its module's source and of the sources of everything it
resolves into, so it caches cleanly:

- each module's entry is keyed by the sha256 of its source; a hash
  mismatch, or a file the cache has never seen, makes the module
  **dirty**;
- dirtiness spreads over the *reverse* import graph (a module importing a
  dirty one may lift other chains through it), so the **servable** set is
  `clean - reverse-closure(dirty)`;
- a servable module's analyses are read back (`lookup`) and its bodies
  are not walked; everything else is computed and stored after the run.

Events are cached with the summaries, so a warm run gives the findings of
a cold one (`tests/test_torch_tpulint.py` holds it). The file is
`<root>/.tpulint_torch_cache.json` (git-ignored; the JAX package's lint
keeps its own file); a corrupt or version-mismatched file is treated as
empty, never trusted.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import Summary, SyncEvent, SyncSite

CACHE_VERSION = 1
DEFAULT_NAME = ".tpulint_torch_cache.json"


def cache_path(root: str) -> str:
    return os.path.join(root, DEFAULT_NAME)


def content_hash(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8")).hexdigest()[:24]


# ---------------------------------------------------------------------------
# (de)serialization: plain JSON, no pickle (the cache is repo-local and
# survives interpreter versions)
# ---------------------------------------------------------------------------

def _site_to_json(site: SyncSite) -> dict:
    return {
        "kind": site.kind,
        "detail": site.detail,
        "path": site.sink_path,
        "line": site.sink_line,
        "funcs": list(site.funcs),
        "documented": site.documented,
    }


def _site_from_json(d: dict) -> SyncSite:
    return SyncSite(
        kind=d["kind"],
        detail=d["detail"],
        sink_path=d["path"],
        sink_line=int(d["line"]),
        funcs=tuple(d.get("funcs", ())),
        documented=bool(d.get("documented", False)),
    )


def _summary_to_json(summary: Summary) -> dict:
    return {
        "returnsDevice": summary.returns_device,
        "returnsParams": sorted(summary.returns_params),
        "paramSyncs": [
            [i, [_site_to_json(s) for s in sites]]
            for i, sites in summary.param_syncs
        ],
    }


def _summary_from_json(d: dict) -> Summary:
    return Summary(
        returns_device=bool(d.get("returnsDevice", False)),
        returns_params=frozenset(int(i) for i in d.get("returnsParams", ())),
        param_syncs=tuple(
            (int(i), tuple(_site_from_json(s) for s in sites))
            for i, sites in d.get("paramSyncs", ())
        ),
    )


def _sources_to_json(sources) -> list:
    return sorted(sources, key=lambda s: (isinstance(s, str), s))


def _event_to_json(event: SyncEvent) -> dict:
    return {
        "line": event.line,
        "kind": event.kind,
        "detail": event.detail,
        "sources": _sources_to_json(event.sources),
        "path": event.sink_path,
        "sinkLine": event.sink_line,
        "funcs": list(event.funcs),
        "documented": event.documented,
    }


def _event_from_json(d: dict) -> SyncEvent:
    return SyncEvent(
        line=int(d["line"]),
        kind=d["kind"],
        detail=d["detail"],
        sources=frozenset(
            s if isinstance(s, str) else int(s) for s in d.get("sources", ())
        ),
        sink_path=d["path"],
        sink_line=int(d["sinkLine"]),
        funcs=tuple(d.get("funcs", ())),
        documented=bool(d.get("documented", False)),
    )


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class SummaryCache:
    """A loaded cache and the servable set of one run.

    Lifecycle: `load`, then `prepare` (the dirty and servable sets against
    a live Project), lookups during the run, then `store_analyses` and
    `save`.
    """

    def __init__(self, path: str, files: Optional[Dict[str, dict]] = None):
        self.path = path
        #: relpath -> {"hash": str, "functions": {qualname: {...}}}
        self.files: Dict[str, dict] = files if files is not None else {}
        self.servable: Set[str] = set()
        self.dirty: Set[str] = set()
        self.hits = 0
        self.misses = 0

    # -- persistence ---------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "SummaryCache":
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("version") != CACHE_VERSION:
                return cls(path)
            files = payload.get("files", {})
            if not isinstance(files, dict):
                return cls(path)
            return cls(path, files)
        except (OSError, ValueError):
            return cls(path)

    def save(self) -> None:
        tmp = self.path + ".tmp"
        payload = {"version": CACHE_VERSION, "files": self.files}
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- invalidation --------------------------------------------------------
    def prepare(self, project) -> None:
        """Compute this run's dirty and servable sets against the live
        tree: dirty = hash mismatch or never seen; servable = clean less
        reverse-import-closure(dirty). Entries for files no longer on
        disk are dropped."""
        from .rules import _jitindex

        live_hashes: Dict[str, str] = {
            m.path: content_hash(m.source) for m in project.modules
        }
        self.dirty = {
            path
            for path, digest in live_hashes.items()
            if self.files.get(path, {}).get("hash") != digest
        }
        # prune entries whose file vanished (renames/deletions)
        for path in list(self.files):
            if path not in live_hashes:
                del self.files[path]

        # reverse import graph: edge imported -> importer
        index = _jitindex.jit_index(project)
        module_paths = {
            m.module_name: m.path for m in project.modules if m.module_name
        }
        importers: Dict[str, Set[str]] = {}
        for path, info in index.items():
            for target_module, original in info.imports.values():
                for candidate in (
                    module_paths.get(target_module),
                    module_paths.get(f"{target_module}.{original}"),
                ):
                    if candidate is not None and candidate != path:
                        importers.setdefault(candidate, set()).add(path)

        invalid = set(self.dirty)
        frontier = list(self.dirty)
        while frontier:
            current = frontier.pop()
            for importer in importers.get(current, ()):
                if importer not in invalid:
                    invalid.add(importer)
                    frontier.append(importer)
        self.servable = set(live_hashes) - invalid
        self._live_hashes = live_hashes

    # -- run-time API --------------------------------------------------------
    def lookup(
        self, path: str, qualname: str
    ) -> Optional[Tuple[List[SyncEvent], Summary]]:
        if path not in self.servable:
            return None
        entry = self.files.get(path, {}).get("functions", {}).get(qualname)
        if entry is None:
            self.misses += 1
            return None
        try:
            events = [_event_from_json(e) for e in entry.get("events", ())]
            summary = _summary_from_json(entry.get("summary", {}))
        except (KeyError, TypeError, ValueError):
            self.misses += 1
            return None
        self.hits += 1
        return events, summary

    def store_analyses(self, graph) -> None:
        """Fold every analysis the run computed (or re-served) back into
        the cache, under the live content hashes."""
        by_path: Dict[str, Dict[str, dict]] = {}
        for (path, qualname), analysis in graph._analyses.items():
            by_path.setdefault(path, {})[qualname] = {
                "events": [_event_to_json(e) for e in analysis.events],
                "summary": _summary_to_json(analysis.summary),
            }
        for path, digest in getattr(self, "_live_hashes", {}).items():
            entry = self.files.setdefault(path, {"hash": digest, "functions": {}})
            if entry.get("hash") != digest:
                entry["hash"] = digest
                entry["functions"] = {}
            if path in by_path:
                entry["functions"].update(by_path[path])

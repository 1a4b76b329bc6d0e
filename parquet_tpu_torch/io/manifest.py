"""Table manifests: the snapshot layer under writable tables.

The port of ``parquet_tpu/io/manifest.py``.  A writable table
(``dataset_writer.py``) is a directory of part files and one small
manifest file naming the parts of the current snapshot.  The manifest is
the table's one source of truth and its one commit point: the
:class:`~parquet_tpu_torch.io.sink.AtomicFileSink` pattern (temp write,
fsync, rename, fsync of the directory) lifted from one file to the table.

- Part files land under unique names first (``part-<rand>.parquet``, each
  through an atomic sink), so nothing a writer does before the manifest's
  rename is visible.  The rename is the commit: a crash at any byte of an
  ingest or a compaction leaves the old snapshot or the new one.
- Recovery is a sweep (:func:`sweep_orphans`): ``*.tmp`` files and parts
  the live manifest does not name are removed; a named part never is.
- Each entry keeps per-column zone maps (min, max, null count, value
  count) taken from the part's footer statistics at commit, so a dataset
  can drop a part without opening it (:func:`manifest_may_match`, which
  answers True on any doubt), and an aggregate can answer a part that the
  zone maps prove covered (:func:`manifest_all_match`).
- Commits are optimistic: every commit re-reads the live manifest under a
  per-directory lock and publishes through a compare-and-swap on its
  version (:func:`cas_commit_local`, an ``O_EXCL`` claim file), so
  concurrent ingests merge and a compaction whose inputs a rival removed
  aborts instead of bringing replaced parts back.

The serialized bytes equal the JAX package's for the same manifest: a
table written by either package is read by the other.  Every arbitrated
commit counts in ``fleet.cas_commits`` (a lost race in
``fleet.cas_conflicts``) and a sweep's removals in
``table.orphans_swept``.  The JAX package's lock factory
(``utils/locks.py``) is not ported: the locks here are plain
``threading`` locks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..errors import CorruptedError
from ..obs.metrics import counter as _counter
from ..obs.scope import account as _account
from ..utils.env import env_float, env_int
from .sink import AtomicFileSink
from ..utils.locks import make_lock

_M_CAS_COMMITS = _counter("fleet.cas_commits")
_M_CAS_CONFLICTS = _counter("fleet.cas_conflicts")
_M_ORPHANS = _counter("table.orphans_swept")

__all__ = ["ManifestEntry", "Manifest", "MANIFEST_NAME", "PART_PREFIX",
           "CLAIM_NAME", "read_manifest", "write_manifest",
           "commit_manifest", "collect_entry", "manifest_may_match",
           "manifest_all_match", "sweep_orphans", "cas_commit_local",
           "set_commit_arbiter", "part_file_name", "manifest_path",
           "register_sweep_exempt"]

MANIFEST_NAME = "_table_manifest.json"
PART_PREFIX = "part-"
# the commit claim (cas_commit_local): its ``.tmp`` suffix makes a claim
# that a dead committer left an orphan, which sweep_orphans removes
CLAIM_NAME = "_manifest_claim.tmp"
_FORMAT = 1


# ---------------------------------------------------------------------------
# the value codec
# ---------------------------------------------------------------------------
# Zone-map bounds are in each column's order domain (algebra/compare.py):
# a Python int, float, bytes or bool.  JSON holds none of them losslessly,
# so a value carries a one-letter tag: floats go through repr (inf, -0.0
# and nan included), bytes through hex.  A tag the codec does not know
# decodes to None, an unknown bound that every reader takes as
# inconclusive.


def _enc_value(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return {"t": "b", "v": bool(v)}
    item = getattr(v, "item", None)  # a numpy scalar as its Python value
    if item is not None and not isinstance(v, (bytes, bytearray)):
        v = item()
    if isinstance(v, bool):
        return {"t": "b", "v": v}
    if isinstance(v, int):
        return {"t": "i", "v": v}
    if isinstance(v, float):
        return {"t": "f", "v": repr(v)}
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {"t": "x", "v": bytes(v).hex()}
    return None  # not encodable: an unknown bound


def _dec_value(d):
    if d is None or not isinstance(d, dict):
        return None
    t, v = d.get("t"), d.get("v")
    try:
        if t == "b":
            return bool(v)
        if t == "i":
            return int(v)
        if t == "f":
            return float(v)
        if t == "x":
            return bytes.fromhex(v)
    except (TypeError, ValueError):
        return None
    return None  # an unknown tag: inconclusive


@dataclass
class ManifestEntry:
    """One part file of a snapshot.  ``zone_maps`` maps a flat column's
    dotted path to ``(min, max, null_count, num_values)`` in its order
    domain; an element is None where the footer's statistics lacked it
    (inconclusive: pruning keeps the part)."""

    name: str
    num_rows: int
    file_size: int
    zone_maps: Dict[str, Tuple] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"name": self.name, "num_rows": self.num_rows,
                "file_size": self.file_size,
                "zone_maps": {c: [_enc_value(mn), _enc_value(mx), nulls, nv]
                              for c, (mn, mx, nulls, nv)
                              in sorted(self.zone_maps.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "ManifestEntry":
        zm = {}
        for c, rec in (d.get("zone_maps") or {}).items():
            mn, mx, nulls, nv = (list(rec) + [None] * 4)[:4]
            zm[c] = (_dec_value(mn), _dec_value(mx),
                     None if nulls is None else int(nulls),
                     None if nv is None else int(nv))
        return cls(name=str(d["name"]), num_rows=int(d["num_rows"]),
                   file_size=int(d["file_size"]), zone_maps=zm)


@dataclass
class Manifest:
    """One snapshot of a table: its part files in order and its sorting
    spec (``(path, descending, nulls_first)`` tuples, what a compaction
    merges by).  ``version`` only grows; ``created`` is whole Unix seconds,
    so the serialized bytes are deterministic."""

    version: int = 0
    files: List[ManifestEntry] = field(default_factory=list)
    sorting: List[Tuple[str, bool, bool]] = field(default_factory=list)
    created: int = 0

    @property
    def num_rows(self) -> int:
        return sum(e.num_rows for e in self.files)

    def names(self) -> List[str]:
        return [e.name for e in self.files]

    def serialize(self) -> bytes:
        doc = {"format": _FORMAT, "version": self.version,
               "created": int(self.created),
               "sorting": [[p, bool(d), bool(nf)]
                           for p, d, nf in self.sorting],
               "files": [e.as_dict() for e in self.files]}
        return (json.dumps(doc, sort_keys=True, separators=(",", ":"))
                + "\n").encode("utf-8")

    @classmethod
    def deserialize(cls, raw: bytes) -> "Manifest":
        try:
            doc = json.loads(raw.decode("utf-8"))
            if not isinstance(doc, dict) or "version" not in doc:
                raise ValueError("not a manifest document")
            return cls(
                version=int(doc["version"]),
                created=int(doc.get("created", 0)),
                sorting=[(str(p), bool(d), bool(nf))
                         for p, d, nf in (doc.get("sorting") or [])],
                files=[ManifestEntry.from_dict(e)
                       for e in (doc.get("files") or [])])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            raise CorruptedError(f"bad table manifest: {e}") from e


# ---------------------------------------------------------------------------
# read, write, commit
# ---------------------------------------------------------------------------

def manifest_path(table_dir) -> str:
    return os.path.join(os.fspath(table_dir), MANIFEST_NAME)


def part_file_name(token: str) -> str:
    return f"{PART_PREFIX}{token}.parquet"


def read_manifest(table_dir) -> Optional[Manifest]:
    """The live snapshot, or None where the table never committed.  A
    manifest that does not parse raises ``CorruptedError``: the atomic
    commit never leaves one torn."""
    try:
        with open(manifest_path(table_dir), "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    return Manifest.deserialize(raw)


def write_manifest(table_dir, manifest: Manifest,
                   sink_wrap: Optional[Callable] = None) -> None:
    """Replace the live manifest atomically: the table's commit point.
    ``sink_wrap`` puts a crash harness between the bytes and the atomic
    sink (``io/faults.py::SharedCrashState.wrap``)."""
    sink = AtomicFileSink(manifest_path(table_dir))
    wrapped = sink_wrap(sink) if sink_wrap is not None else sink
    try:
        wrapped.write(manifest.serialize())
        wrapped.close()  # fsync, rename, fsync of the directory
    except BaseException:
        wrapped.abort()
        raise


# one lock a table directory: two committers of one process must not
# interleave their read-modify-write cycles (other processes go through
# the claim file of cas_commit_local)
_DIR_LOCKS: Dict[str, threading.Lock] = {}
_DIR_LOCKS_GUARD = make_lock("manifest.dir_registry")


def _dir_lock(table_dir) -> threading.Lock:
    key = os.path.abspath(os.fspath(table_dir))
    with _DIR_LOCKS_GUARD:
        lock = _DIR_LOCKS.get(key)
        if lock is None:
            lock = _DIR_LOCKS[key] = make_lock("manifest.dir")
        return lock


# ---------------------------------------------------------------------------
# the commit arbiter: a compare-and-swap on the manifest's version
# ---------------------------------------------------------------------------
# An arbiter is ``fn(table_dir, expected_version, manifest, sink_wrap) ->
# (committed, live_version)``: it commits the successor only if the live
# version still equals the one the mutation was computed from.  The
# default is cas_commit_local; a resolver set by set_commit_arbiter may
# route a table's commits elsewhere.

_ARBITER_GUARD = make_lock("manifest.arbiter")
_ARBITER_RESOLVER: Optional[Callable] = None


def set_commit_arbiter(resolver: Optional[Callable]) -> None:
    """Set (or with None remove) the process's arbiter resolver,
    ``resolver(table_dir) -> arbiter or None``; None falls back to
    :func:`cas_commit_local`."""
    global _ARBITER_RESOLVER
    with _ARBITER_GUARD:
        _ARBITER_RESOLVER = resolver


def _resolve_arbiter(table_dir) -> Callable:
    with _ARBITER_GUARD:
        resolver = _ARBITER_RESOLVER
    if resolver is not None:
        arb = resolver(table_dir)
        if arb is not None:
            return arb
    return cas_commit_local


def _claim_path(table_dir) -> str:
    return os.path.join(os.fspath(table_dir), CLAIM_NAME)


def _try_claim(claim: str) -> bool:
    try:
        fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def _live_version(table_dir) -> int:
    live = read_manifest(table_dir)
    return live.version if live is not None else 0


def cas_commit_local(table_dir, expected_version: int, manifest: Manifest,
                     sink_wrap: Optional[Callable] = None
                     ) -> Tuple[bool, int]:
    """The default arbiter: an ``O_EXCL`` claim file is the lock between
    processes, and inside it the live version is read again; the commit
    runs only if it still equals ``expected_version``.  A claim older than
    ``PARQUET_TPU_TORCH_FLEET_CAS_TTL_S`` (read at each call) belongs to a
    committer that died and is broken; a fresh one held by a rival is a
    conflict.  Returns ``(committed, live_version_seen)``."""
    claim = _claim_path(table_dir)
    if not _try_claim(claim):
        try:
            # the claim file's age on the wall clock of file times
            # ptlint: disable=PT004 -- a file's mtime is wall time: its
            # age is taken on the same clock, not deadline math
            age = time.time() - os.path.getmtime(claim)
        except OSError:
            age = None  # released between the open and the stat
        if age is None or age <= max(
                env_float("PARQUET_TPU_TORCH_FLEET_CAS_TTL_S"), 0.0):
            return False, _live_version(table_dir)
        try:  # expired: break it, and race for it again
            os.unlink(claim)
        except OSError:
            pass
        if not _try_claim(claim):
            return False, _live_version(table_dir)
    try:
        cur = _live_version(table_dir)
        if cur != expected_version:
            return False, cur
        write_manifest(table_dir, manifest, sink_wrap=sink_wrap)
        return True, manifest.version
    finally:
        try:
            os.unlink(claim)
        except OSError:
            pass


def commit_manifest(table_dir,
                    mutate: Callable[[Manifest], Optional[Manifest]],
                    sink_wrap: Optional[Callable] = None
                    ) -> Optional[Manifest]:
    """One read-modify-write commit: ``mutate(live)`` gets the live
    manifest (an empty version 0 one for a new table) and returns the
    successor, or None to abort (a compaction whose inputs a rival
    removed).  The successor is stamped ``live.version + 1`` here and
    published through the arbiter; on a conflict the loop reads and
    mutates again, ``PARQUET_TPU_TORCH_FLEET_CAS_RETRIES`` times at most
    (read at each call), then raises ``OSError``."""
    arbiter = _resolve_arbiter(table_dir)
    attempts = max(env_int("PARQUET_TPU_TORCH_FLEET_CAS_RETRIES"), 0) + 1
    with _dir_lock(table_dir):
        for attempt in range(attempts):
            live = read_manifest(table_dir)
            if live is None:
                live = Manifest(version=0)
            # taken before the stamp: mutate may return ``live`` itself
            expected = live.version
            new = mutate(live)
            if new is None:
                return None
            new.version = expected + 1
            if not new.created:
                # ptlint: disable=PT004 -- the manifest's creation stamp
                # (a persisted record), not deadline math
                new.created = int(time.time())
            ok, _seen = arbiter(table_dir, expected, new, sink_wrap)
            if ok:
                _account(_M_CAS_COMMITS)
                return new
            _account(_M_CAS_CONFLICTS)
            if attempt + 1 < attempts:
                time.sleep(min(0.01 * (attempt + 1), 0.2))
        raise OSError(
            f"manifest commit for {os.fspath(table_dir)!r} lost the "
            f"compare-and-swap {attempts} time(s): a rival committer holds "
            f"the claim or keeps moving the version")


# ---------------------------------------------------------------------------
# zone maps, from a part's footer at commit
# ---------------------------------------------------------------------------

def collect_entry(table_dir, name: str) -> ManifestEntry:
    """A part's manifest entry from its committed footer: per flat column
    the least of the row groups' minimums, the greatest of their maximums,
    and the summed null and value counts; None wherever a row group lacks
    them."""
    from .reader import ParquetFile

    pf = ParquetFile(os.path.join(os.fspath(table_dir), name))
    try:
        zm: Dict[str, Tuple] = {}
        for leaf in pf.schema.leaves:
            if leaf.max_repetition_level:
                continue  # a repeated column has no row-aligned zone map
            mins, maxs = [], []
            nulls, nv = 0, 0
            have_nulls = have_nv = True
            for rg in pf.row_groups:
                chunk = rg.column(leaf.column_index)
                st = chunk.statistics()
                mins.append(None if st is None else st.min_value)
                maxs.append(None if st is None else st.max_value)
                if st is None or st.null_count is None:
                    have_nulls = False
                else:
                    nulls += st.null_count
                if chunk.meta.num_values is None:
                    have_nv = False
                else:
                    nv += chunk.meta.num_values
            mn = (None if not mins or any(m is None for m in mins)
                  else min(mins))
            mx = (None if not maxs or any(m is None for m in maxs)
                  else max(maxs))
            zm[leaf.dotted_path] = (mn, mx, nulls if have_nulls else None,
                                    nv if have_nv else None)
        return ManifestEntry(name=name, num_rows=pf.num_rows,
                             file_size=pf.source.size(), zone_maps=zm)
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# pruning from the manifest (no IO)
# ---------------------------------------------------------------------------

def _zone_alive(pred, entry: ManifestEntry) -> bool:
    """May the part hold a row that matches ``pred``?  The planner's
    ``_stats_alive`` over the persisted zone map in place of the footer,
    with the same conservative rules."""
    zm = entry.zone_maps.get(pred.path)
    if zm is None:
        return True  # no zone map for the column: inconclusive
    mn, mx, nulls, nv = zm
    if pred.kind == "null":
        if pred.leaf is not None and pred.leaf.max_definition_level == 0:
            return False  # a required column holds no null
        return nulls is None or nulls > 0
    if pred.kind == "notnull":
        return not (nulls is not None and nv is not None and nulls >= nv)
    # a range or an IN list needs a non-null value
    if nulls is not None and nv is not None and nulls >= nv:
        return False
    if mn is None or mx is None:
        return True
    try:
        if pred.kind == "range":
            if not pred.negated:
                return not ((pred.lo is not None and mx < pred.lo)
                            or (pred.hi is not None and mn > pred.hi))
            # negated: dead only when every value lies inside the range
            return not ((pred.lo is None or pred.lo <= mn)
                        and (pred.hi is None or mx <= pred.hi))
        from .search import _any_in_range

        if not pred.negated:
            return _any_in_range(pred.values, mn, mx)
        from .planner import _not_in_covers

        return not _not_in_covers(pred.values, mn, mx)
    except TypeError:
        return True  # the probe does not compare with the stored domain


def _zone_covers(pred, entry: ManifestEntry) -> bool:
    """Does the part's zone map prove that every row matches ``pred``?
    The planner's one coverage rule (``_bounds_cover``); no zone map
    proves nothing."""
    from .planner import _bounds_cover

    zm = entry.zone_maps.get(pred.path)
    if zm is None:
        return False
    mn, mx, nulls, nv = zm
    return _bounds_cover(pred, mn, mx, nulls, nv)


def manifest_all_match(entry: ManifestEntry, expr) -> bool:
    """Does the part hold only matching rows?  ``expr`` is a prepared
    tree; the answer is zone-map arithmetic, and the part is never
    opened."""
    from ..algebra.expr import Const
    from .planner import _tree_covers

    if isinstance(expr, Const):
        return expr.value
    return _tree_covers(expr, lambda p: _zone_covers(p, entry))


def manifest_may_match(entry: ManifestEntry, expr) -> bool:
    """May the part hold a matching row?  ``expr`` is a prepared tree
    (``algebra/expr.py::prepare``); no IO of any kind."""
    from ..algebra.expr import Const
    from .planner import _eval_tree

    if isinstance(expr, Const):
        return expr.value
    alive, _ = _eval_tree(expr, lambda p: _zone_alive(p, entry))
    return alive


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

# A live writer's flushed but uncommitted parts, and a compaction's merged
# part before its commit, look like orphans on disk.  Actors of this
# process register a provider of such names for a directory, and the sweep
# leaves them (and their ``<name>.<rand>.tmp`` temps) alone.  Writers in
# other processes have no such shield: recover a table when no other
# process is committing to it.
_SWEEP_EXEMPT_PROVIDERS: List[Callable[[str], set]] = []


def register_sweep_exempt(fn: Callable[[str], set]) -> None:
    """Register ``fn(abs_table_dir) -> set of part names`` that the
    orphan sweep must leave alone."""
    if fn not in _SWEEP_EXEMPT_PROVIDERS:
        _SWEEP_EXEMPT_PROVIDERS.append(fn)


def _sweep_exempt(table_dir_abs: str) -> set:
    names: set = set()
    for fn in list(_SWEEP_EXEMPT_PROVIDERS):
        try:
            names |= fn(table_dir_abs)
        except Exception:
            continue  # a broken provider must not block recovery
    return names


def sweep_orphans(table_dir) -> List[str]:
    """Crash recovery: remove every ``*.tmp`` and every part the live
    manifest does not name, but the in-flight work of this process's
    writers and compactions.  A named part is never touched.  Returns the
    removed names."""
    table_dir = os.fspath(table_dir)
    removed: List[str] = []
    with _dir_lock(table_dir):
        live = read_manifest(table_dir)
        keep = set(live.names()) if live is not None else set()
        exempt = _sweep_exempt(os.path.abspath(table_dir))
        try:
            names = sorted(os.listdir(table_dir))
        except FileNotFoundError:
            return removed
        for name in names:
            orphan = (name.endswith(".tmp")
                      or (name.startswith(PART_PREFIX)
                          and name.endswith(".parquet")
                          and name not in keep))
            if not orphan or name in keep:
                continue
            if any(name == p or name.startswith(p + ".") for p in exempt):
                continue  # in flight: its commit may land after us
            try:
                os.unlink(os.path.join(table_dir, name))
                removed.append(name)
            except OSError:
                pass  # the next recovery tries again
    _account(_M_ORPHANS, len(removed))
    return removed

"""SQLite metadata store, schema-compatible with the reference DB.

Preserves the exact table set and columns of smart_face_recognition.py:
persons (:207-218), face_quality (:221-232), person_visits (:235-248),
low_similarity_images (:1686-1699), plus the reason-column/embedding-column
migrations (:254-316) so the reference's committed face_database.db opens
unchanged. All methods use short-lived connections (same concurrency model
as the reference) with WAL enabled for parallel readers. A copy of the JAX
package's ``apps/metadata_db.py`` (sqlite3 only).
"""
from __future__ import annotations

import sqlite3
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


class MetadataDB:
    def __init__(self, path: str = "face_database.db"):
        self.path = path
        self.setup()
        self.migrate()

    @contextmanager
    def _conn(self):
        # sqlite3.Connection's own context manager only scopes the
        # transaction — it never closes the handle, leaving closure to
        # refcount GC; close explicitly so connections (and their WAL
        # locks) end with the call
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    # ------------------------------------------------------------- schema

    def setup(self) -> None:
        with self._conn() as conn:
            conn.execute('''
                CREATE TABLE IF NOT EXISTS persons (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    name TEXT NOT NULL,
                    image_path TEXT,
                    face_quality REAL,
                    face_hash TEXT UNIQUE,
                    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                    last_seen TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                    match_count INTEGER DEFAULT 0
                )''')
            conn.execute('''
                CREATE TABLE IF NOT EXISTS face_quality (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    person_id INTEGER,
                    quality_score REAL,
                    blur_score REAL,
                    pose_score REAL,
                    lighting_score REAL,
                    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                    FOREIGN KEY (person_id) REFERENCES persons (id)
                )''')
            conn.execute('''
                CREATE TABLE IF NOT EXISTS person_visits (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    person_id INTEGER,
                    visit_id TEXT,
                    customer_id TEXT,
                    entry_time TEXT,
                    image_url TEXT,
                    saved_image_path TEXT,
                    similarity REAL,
                    processed_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                    FOREIGN KEY (person_id) REFERENCES persons (id)
                )''')
            conn.execute('''
                CREATE TABLE IF NOT EXISTS low_similarity_images (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    visit_id TEXT,
                    customer_id TEXT,
                    entry_time TEXT,
                    image_url TEXT,
                    saved_image_path TEXT,
                    similarity REAL,
                    best_match_name TEXT,
                    reason TEXT,
                    processed_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP
                )''')

    def migrate(self) -> None:
        """Reference migrations: add low_similarity_images.reason; drop the
        legacy persons.embedding BLOB column if present."""
        with self._conn() as conn:
            try:
                conn.execute("ALTER TABLE low_similarity_images ADD COLUMN reason TEXT")
            except sqlite3.OperationalError:
                pass
            cols = [r[1] for r in conn.execute("PRAGMA table_info(persons)")]
            if "embedding" in cols:
                conn.executescript('''
                    CREATE TABLE persons_new (
                        id INTEGER PRIMARY KEY AUTOINCREMENT,
                        name TEXT NOT NULL,
                        image_path TEXT,
                        face_quality REAL,
                        face_hash TEXT UNIQUE,
                        created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                        last_seen TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
                        match_count INTEGER DEFAULT 0
                    );
                    INSERT INTO persons_new (id, name, image_path, face_quality,
                        face_hash, created_at, last_seen, match_count)
                    SELECT id, name, image_path, face_quality, face_hash,
                        created_at, last_seen, match_count FROM persons;
                    DROP TABLE persons;
                    ALTER TABLE persons_new RENAME TO persons;
                ''')

    # ------------------------------------------------------------ persons

    def find_person_by_hash(self, face_hash: str) -> Optional[int]:
        with self._conn() as conn:
            row = conn.execute("SELECT id FROM persons WHERE face_hash = ?",
                               (face_hash,)).fetchone()
        return row[0] if row else None

    def insert_person(self, name: str, image_path: Optional[str],
                      face_quality: float, face_hash: str,
                      quality: Optional[Dict[str, float]] = None) -> int:
        with self._conn() as conn:
            cur = conn.execute(
                "INSERT INTO persons (name, image_path, face_quality, face_hash)"
                " VALUES (?, ?, ?, ?)",
                (name, image_path, face_quality, face_hash))
            pid = cur.lastrowid
            if quality is not None:
                conn.execute(
                    "INSERT INTO face_quality (person_id, quality_score,"
                    " blur_score, pose_score, lighting_score)"
                    " VALUES (?, ?, ?, ?, ?)",
                    (pid, quality.get("overall"), quality.get("blur"),
                     quality.get("pose"), quality.get("lighting")))
            return pid

    def delete_person(self, person_id: int) -> None:
        with self._conn() as conn:
            conn.execute("DELETE FROM persons WHERE id = ?", (person_id,))

    def update_person_stats(self, person_id: int) -> None:
        with self._conn() as conn:
            conn.execute(
                "UPDATE persons SET last_seen = CURRENT_TIMESTAMP,"
                " match_count = match_count + 1 WHERE id = ?", (person_id,))

    def get_person(self, person_id: int) -> Optional[Dict[str, Any]]:
        with self._conn() as conn:
            row = conn.execute(
                "SELECT id, name, image_path, face_quality, match_count,"
                " created_at, last_seen FROM persons WHERE id = ?",
                (person_id,)).fetchone()
        if row is None:
            return None
        keys = ["id", "name", "image_path", "face_quality", "match_count",
                "created_at", "last_seen"]
        return dict(zip(keys, row))

    def list_persons(self) -> List[Tuple[int, str]]:
        with self._conn() as conn:
            return list(conn.execute("SELECT id, name FROM persons ORDER BY id"))

    # ------------------------------------------------------------- visits

    def store_visit(self, person_id: int, visit_id: str, customer_id: str,
                    entry_time: str, image_url: str,
                    saved_image_path: Optional[str], similarity: float) -> None:
        with self._conn() as conn:
            # the reference schema (which the committed face_database.db
            # must keep opening) has no UNIQUE constraint, so OR REPLACE
            # could never fire — dedupe explicitly instead of accumulating
            # duplicate rows on re-processed visits
            conn.execute(
                "DELETE FROM person_visits WHERE person_id = ? AND"
                " visit_id = ?", (person_id, visit_id))
            conn.execute(
                "INSERT INTO person_visits (person_id, visit_id,"
                " customer_id, entry_time, image_url, saved_image_path,"
                " similarity) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (person_id, visit_id, customer_id, entry_time, image_url,
                 saved_image_path, similarity))

    def visits_for_person(self, person_id: int) -> List[Dict[str, Any]]:
        with self._conn() as conn:
            rows = conn.execute(
                "SELECT visit_id, customer_id, entry_time, image_url,"
                " saved_image_path, similarity FROM person_visits"
                " WHERE person_id = ? ORDER BY entry_time DESC",
                (person_id,)).fetchall()
        keys = ["visit_id", "customer_id", "entry_time", "image_url",
                "saved_image_path", "similarity"]
        return [dict(zip(keys, r)) for r in rows]

    def image_url_seen(self, image_url: str) -> bool:
        with self._conn() as conn:
            n1 = conn.execute("SELECT COUNT(*) FROM person_visits WHERE"
                              " image_url = ?", (image_url,)).fetchone()[0]
            n2 = conn.execute("SELECT COUNT(*) FROM low_similarity_images"
                              " WHERE image_url = ?", (image_url,)).fetchone()[0]
        return n1 > 0 or n2 > 0

    def repoint_visits(self, from_person: int, to_person: int) -> None:
        with self._conn() as conn:
            conn.execute("UPDATE person_visits SET person_id = ? WHERE"
                         " person_id = ?", (to_person, from_person))
            conn.execute(
                "UPDATE persons SET match_count = match_count + "
                "(SELECT match_count FROM persons WHERE id = ?) WHERE id = ?",
                (from_person, to_person))
            conn.execute("DELETE FROM persons WHERE id = ?", (from_person,))

    # ----------------------------------------------------- low similarity

    def store_low_similarity(self, visit_id: str, customer_id: str,
                             entry_time: str, image_url: str,
                             saved_image_path: Optional[str], similarity: float,
                             best_match_name: Optional[str] = None,
                             reason: Optional[str] = None) -> None:
        with self._conn() as conn:
            conn.execute(
                "INSERT INTO low_similarity_images (visit_id, customer_id,"
                " entry_time, image_url, saved_image_path, similarity,"
                " best_match_name, reason) VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                (visit_id, customer_id, entry_time, image_url,
                 saved_image_path, similarity, best_match_name, reason))

    def low_similarity_rows(self) -> List[Dict[str, Any]]:
        with self._conn() as conn:
            rows = conn.execute(
                "SELECT visit_id, customer_id, entry_time, image_url,"
                " saved_image_path, similarity, best_match_name, reason,"
                " processed_at FROM low_similarity_images"
                " ORDER BY similarity DESC, processed_at DESC").fetchall()
        keys = ["visit_id", "customer_id", "entry_time", "image_url",
                "saved_image_path", "similarity", "best_match_name",
                "reason", "processed_at"]
        return [dict(zip(keys, r)) for r in rows]

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._conn() as conn:
            total_persons = conn.execute("SELECT COUNT(*) FROM persons").fetchone()[0]
            avg_quality = conn.execute(
                "SELECT AVG(face_quality) FROM persons").fetchone()[0] or 0
            recent = conn.execute(
                "SELECT COUNT(*) FROM persons WHERE last_seen > "
                "datetime('now', '-1 day')").fetchone()[0]
            total_visits = conn.execute(
                "SELECT COUNT(DISTINCT visit_id) FROM person_visits").fetchone()[0]
            total_images = conn.execute(
                "SELECT COUNT(DISTINCT image_url) FROM person_visits").fetchone()[0]
            low_sim = conn.execute(
                "SELECT COUNT(*) FROM low_similarity_images").fetchone()[0]
        return {"total_persons": total_persons,
                "average_quality": float(avg_quality),
                "recent_activity": recent, "total_visits": total_visits,
                "total_images": total_images, "low_similarity_count": low_sim}

    def person_groups(self) -> List[Dict[str, Any]]:
        """persons x person_visits join for the web UI
        (smart_face_recognition.py:2400-2489 semantics)."""
        with self._conn() as conn:
            persons = conn.execute('''
                SELECT p.id, p.name, p.image_path, p.face_quality,
                       p.match_count, p.last_seen, COUNT(v.visit_id)
                FROM persons p
                LEFT JOIN (SELECT DISTINCT person_id, visit_id, entry_time,
                           image_url, saved_image_path FROM person_visits) v
                    ON p.id = v.person_id
                GROUP BY p.id, p.name, p.image_path, p.face_quality,
                         p.match_count, p.last_seen
                ORDER BY p.match_count DESC, p.last_seen DESC
            ''').fetchall()
        groups = []
        for (pid, name, image_path, quality, match_count, last_seen,
             visit_count) in persons:
            visits = self.visits_for_person(pid)
            images = []
            for v in visits:
                if v["similarity"] is None:
                    continue
                display = v["saved_image_path"] or v["image_url"]
                images.append({"visit_id": v["visit_id"],
                               "customer_id": v["customer_id"],
                               "entry_time": v["entry_time"],
                               "image_url": v["image_url"],
                               "image_path": display,
                               "similarity": v["similarity"]})
            if not images and image_path:
                images.append({"visit_id": f"person_{pid}",
                               "customer_id": name,
                               "entry_time": last_seen or "",
                               "image_url": image_path,
                               "image_path": image_path, "similarity": 1.0})
            groups.append({"person_id": pid, "name": name,
                           "image_path": image_path, "face_quality": quality,
                           "match_count": match_count, "last_seen": last_seen,
                           "visit_count": visit_count, "avg_quality": quality,
                           "images": images})
        return groups

    def clear_all(self) -> None:
        with self._conn() as conn:
            conn.execute("DELETE FROM person_visits")
            conn.execute("DELETE FROM low_similarity_images")
            conn.execute("DELETE FROM face_quality")
            conn.execute("DELETE FROM persons")
            conn.execute("DELETE FROM sqlite_sequence WHERE name IN "
                         "('persons', 'face_quality', 'person_visits',"
                         " 'low_similarity_images')")

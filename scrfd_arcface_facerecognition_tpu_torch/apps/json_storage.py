"""Clustering-result JSON export.

Writes clustering_results_<YYYYmmdd_HHMMSS>_<jobid8>.json files with the
payload/group schema of the reference exporter (json_storage.py:192-245,
group schema :117-139), so downstream consumers of clustering_results/
keep working unchanged. A copy of the JAX package's ``apps/json_storage.py``
(host code only).
"""
from __future__ import annotations

import json
import os
import uuid
from collections import Counter
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional


def _avg_age(visits: List[Dict[str, Any]]) -> Optional[int]:
    ages = []
    for visit in visits:
        for source in [visit] + list(visit.get("entryEventIds") or []):
            if "age" in source:
                try:
                    ages.append(int(source["age"]))
                except (ValueError, TypeError):
                    pass
    return round(sum(ages) / len(ages)) if ages else None


def _common_gender(visits: List[Dict[str, Any]]) -> Optional[str]:
    genders = []
    for visit in visits:
        for source in [visit] + list(visit.get("entryEventIds") or []):
            g = source.get("gender")
            if g and str(g).lower() in ("male", "female", "m", "f"):
                genders.append(str(g).lower())
    return Counter(genders).most_common(1)[0][0] if genders else None


class JSONStorageManager:
    def __init__(self, output_dir: str = "clustering_results"):
        self.output_dir = output_dir
        os.makedirs(self.output_dir, exist_ok=True)

    def create_job_id(self) -> str:
        return str(uuid.uuid4())

    def _group_data(self, person_id, person_name, visits, group_score):
        if not visits:
            return {}
        first = visits[0]
        events = first.get("entryEventIds", []) or []
        event_info = events[0] if events else {}
        camera = first.get("camera", "") or event_info.get("camera", "")
        customer = first.get("customer", {}) or {}
        age = customer.get("age")
        gender = customer.get("gender")
        if age is None:
            age = _avg_age(visits)
        if gender is None:
            gender = _common_gender(visits)
        return {
            "group_id": first.get("customerId", first.get("customer_id", "")),
            "person_id": person_id,
            "person_name": person_name,
            "timestamp": first.get("entryTime", first.get("entry_time", "")),
            "group_score": round(group_score, 3),
            "camera": camera,
            "event": event_info.get("event", ""),
            "branchId": first.get("branchId", ""),
            "fileName": event_info.get("fileName", ""),
            "age": age,
            "gender": gender,
            "visit_count": len(visits),
            "visits": [
                {
                    "visit_id": v.get("visit_id", v.get("id")),
                    "customer_id": v.get("customerId", v.get("customer_id")),
                    "image_url": v.get("image_url", v.get("image")),
                    "entry_time": v.get("entryTime", v.get("entry_time")),
                    "similarity": v.get("similarity", 0.0),
                }
                for v in visits
            ],
        }

    def format_groups_for_json(self, person_groups: List[Dict[str, Any]]
                               ) -> List[Dict[str, Any]]:
        out = []
        for group in person_groups:
            visits = group.get("visits", [])
            sims = [v.get("similarity", 0.0) for v in visits
                    if v.get("similarity") is not None]
            score = sum(sims) / len(sims) if sims else 0.0
            data = self._group_data(
                group.get("person_id"),
                group.get("person_name", f"Person_{group.get('person_id')}"),
                visits, score)
            if data:
                out.append(data)
        return out

    def save_clustering_results(self, groups: List[Dict[str, Any]],
                                total_processed: int,
                                results: Dict[str, Any]) -> bool:
        try:
            timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
            job_id = self.create_job_id()
            filename = f"clustering_results_{timestamp}_{job_id[:8]}.json"
            filepath = os.path.join(self.output_dir, filename)
            json_groups = self.format_groups_for_json(groups)
            payload = {
                "job_id": job_id,
                "status": "finished",
                "timestamp": datetime.now(timezone.utc).isoformat()
                             .replace("+00:00", "Z"),
                "total_processed": total_processed,
                "total_groups": len(json_groups),
                "results": results,
                "message": f"Processing completed. Created {len(json_groups)} "
                           f"groups from {total_processed} images",
                "groups": json_groups,
            }
            with open(filepath, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2, ensure_ascii=False)
            return True
        except Exception:
            return False


json_storage_manager = JSONStorageManager()


def save_clustering_results(groups: List[Dict[str, Any]], total_processed: int,
                            results: Dict[str, Any]) -> bool:
    return json_storage_manager.save_clustering_results(
        groups, total_processed, results)

"""Variant (rsID) -> protein reference/alternate sequences (counterpart of
caster_dta_tpu/inference/variant_to_protein.py).

Behavioral spec: reference inference/variant_to_protein.py:6-163: Ensembl
variant_recoder POST for rsID -> protein HGVS (NP_ accessions), Mutalyzer GET
for HGVS -> mutated sequence (the reference allele as ':p.='), a JSON cache
per variant (``variants/<rs>.json``) and a text cache per sequence
(``sequences/<id>.txt``) for offline reruns, and '*'-termination trimming.

HTTP goes through two seams on ``urllib.request``, ``_post_json`` and
``_get_json``, called only for what the caches lack: with full caches the
function makes no request and needs no HTTP package.
"""
from __future__ import annotations

import json
import os
import urllib.request

ENSEMBL_RECODER = "https://rest.ensembl.org/variant_recoder/homo_sapiens"
MUTALYZER_MUTATE = "https://mutalyzer.nl/api/mutate/"


def _post_json(url: str, payload, timeout: int = 120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          "Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get_json(url: str, timeout: int = 120):
    req = urllib.request.Request(url, headers={"accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def process_seq(seq: str) -> str:
    """Trim at the termination character (reference :154-163)."""
    return seq.split("*")[0]


def variant_to_protein_seq(var_dict: dict, cache_dir: str,
                           force_requery: bool = False):
    """var_dict: {variant_name: rsID}. Returns
    ({variant_name: {ref_id: [...], alt_id: [...]}}, {protein_id: sequence})."""
    var_cache = os.path.join(cache_dir, "variants")
    seq_cache = os.path.join(cache_dir, "sequences")
    os.makedirs(var_cache, exist_ok=True)
    os.makedirs(seq_cache, exist_ok=True)

    var_ids = sorted(set(var_dict.values()))
    all_var, uniq_seq = {}, {}

    pending = []
    for var_id in var_ids:
        f = os.path.join(var_cache, f"{var_id}.json")
        if not force_requery and os.path.exists(f):
            with open(f) as fh:
                all_var[var_id] = json.load(fh)
        else:
            pending.append(var_id)

    if pending:
        answer = _post_json(ENSEMBL_RECODER, {"ids": pending})
        for var_id, var_resp in zip(pending, answer):
            alt_ids = []
            for _, allele in var_resp.items():
                if not isinstance(allele, dict):
                    continue
                alt_ids.extend(x for x in allele.get("hgvsp", [])
                               if x.startswith("NP_"))
            alt_ids = sorted(set(alt_ids))
            ref_ids = sorted(set(x.split(":")[0] for x in alt_ids))
            all_var[var_id] = {"ref_id": ref_ids, "alt_id": alt_ids}

    ref_ids = sorted(set(x for v in all_var.values() for x in v["ref_id"]))
    alt_ids = sorted(set(x for v in all_var.values() for x in v["alt_id"]))

    def fetch(pid, hgvs):
        f = os.path.join(seq_cache, f"{pid}.txt")
        if not force_requery and os.path.exists(f):
            with open(f) as fh:
                return fh.read()
        return process_seq(_get_json(MUTALYZER_MUTATE + hgvs)["sequence"]["seq"])

    for rid in ref_ids:
        uniq_seq[rid] = fetch(rid, f"{rid}:p.=")
    for aid in alt_ids:
        uniq_seq[aid] = fetch(aid, aid)

    for var_id, data in all_var.items():
        f = os.path.join(var_cache, f"{var_id}.json")
        if not os.path.exists(f) or force_requery:
            with open(f, "w") as fh:
                json.dump(data, fh)
    for pid, seq in uniq_seq.items():
        f = os.path.join(seq_cache, f"{pid}.txt")
        if not os.path.exists(f) or force_requery:
            with open(f, "w") as fh:
                fh.write(seq)

    ids_to_name = {v: k for k, v in var_dict.items()}
    return ({ids_to_name[k]: v for k, v in all_var.items()}, uniq_seq)

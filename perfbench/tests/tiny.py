"""Tiny configurations and traffic for CPU runs of the harness (widths far
below the published ones: plumbing only)."""

import json
import os

VOCODER = {"num_mels": 80, "upsample_initial_channel": 16, "upsample_rates": [5, 4, 4, 2],
           "upsample_kernel_sizes": [8, 8, 4, 4], "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "resblock": "1", "sampling_rate": 8000}


def t2s(two: bool):
    return {"dim": 32, "source_depth": 1, "target_depth": 1, "heads": 2, "dim_head": 16, "ff_mult": 4,
            "num_text_tokens": 30528, "num_semantic_tokens": 501, "target_dim": 64 if two else 32, "two_output": two}


def acoustic(mode: str):
    return {"dim_in": 160 if mode == "two_one" else 80, "dim": 32, "depth": 2, "heads": 2, "dim_head": 16,
            "ff_mult": 4, "num_phoneme_tokens": 502, "dim_phoneme_emb": 16, "conv_pos_kernel": 31, "mode": mode}


CONFIGS = {
    "covomix": {"dtype": "float32", "t2s": t2s(True), "acoustic": acoustic("two_one"), "vocoder": VOCODER},
    "covosingle": {"dtype": "float32", "t2s": t2s(False), "acoustic": acoustic("single"), "vocoder": VOCODER},
}

OVERRIDES = {
    "covomix.serve_b64": {"requests_per_step": 2, "traffic": {
        "batch": 2, "text_ids": 16, "prompt_frames": 24, "decode_len": 8, "cond_scale": 0.7, "top_k_thres": 0.1,
        "greedy_top_k_thres": 0.001, "greedy_every": 2, "pool": 2, "check_rows": 4, "check_batch": 16}},
    "covosingle.monologue_file": {"traffic": {
        "mode": "covosingle", "text_letters": [20, 30], "word_letters": [2, 9], "texts": 4, "prompts": 3,
        "prompt_seconds": 1, "t2s_max_length": 24, "bucket": 16, "fuse_tail": True, "cond_scale": 0.7,
        "check_files": 2}},
}


def bench(tmp_path, real: dict) -> dict:
    """BENCHMARK.json's cells and metrics with the configurations swapped for
    tiny ones written under tmp_path."""
    out = dict(real)
    out["configs"] = []
    for c in real["configs"]:
        path = os.path.join(str(tmp_path), c["name"] + ".json")
        with open(path, "w") as f:
            json.dump(CONFIGS[c["name"]], f)
        out["configs"].append({**c, "file": path})
    return out

OVERRIDES["covomix.train_t2s"] = {"traffic": {"model": "t2s", "batch": 2, "text_ids": 12, "targets": 20, "k": 2,
                                              "lr": 1e-4}}

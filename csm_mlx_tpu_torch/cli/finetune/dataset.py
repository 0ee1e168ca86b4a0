"""`finetune convert` — a directory of conversation folders -> the training
JSON of `--data-path` (a copy of `csm_mlx_tpu/cli/finetune/dataset.py`,
not an import: the command is pure Python and the port imports nothing of
the JAX package)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

from csm_mlx_tpu_torch.cli.finetune.utils import find_speaker_id, natural_sort_key

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".aac", ".m4a"}


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "convert",
        help="Convert a directory of conversation subfolders into the JSON "
             "format expected by --data-path.",
    )
    p.add_argument("input_dir", type=Path,
                   help="Directory containing conversation subdirectories.")
    p.add_argument("output_json", type=Path,
                   help="Path to save the output JSON file.")
    p.set_defaults(func=run)


def run(args: argparse.Namespace) -> None:
    input_dir: Path = args.input_dir
    output_json: Path = args.output_json
    if not input_dir.is_dir():
        raise SystemExit(f"Error: {input_dir} is not a directory")

    all_conversations: List[List[Dict[str, Any]]] = []
    processed_dirs = 0
    total_samples = 0
    total_skipped = 0

    for item in sorted(input_dir.iterdir()):
        if not item.is_dir():
            continue
        processed_dirs += 1
        audio_files: Dict[str, Path] = {}
        text_files: Dict[str, Path] = {}
        for file_path in item.iterdir():
            if file_path.is_file():
                suffix = file_path.suffix.lower()
                if suffix in AUDIO_EXTENSIONS:
                    audio_files[file_path.stem] = file_path
                elif suffix == ".txt":
                    text_files[file_path.stem] = file_path

        conversation: List[Dict[str, Any]] = []
        skipped = 0
        for base_name in sorted(audio_files.keys(), key=natural_sort_key):
            audio_path = audio_files[base_name]
            if base_name not in text_files:
                skipped += 1
                continue
            speaker_id = find_speaker_id(audio_path.name)
            if speaker_id is None:
                raise SystemExit(
                    f"Error: Could not detect speaker ID for file "
                    f"'{audio_path}'. Filename must include "
                    f"'speaker<digits>' (case-insensitive)."
                )
            try:
                text_content = text_files[base_name].read_text(
                    encoding="utf-8").strip()
            except Exception as e:
                print(f"[convert] could not read "
                      f"'{text_files[base_name].name}': {e} -- skipping")
                skipped += 1
                continue
            if not text_content:
                print(f"[convert] '{item.name}/{text_files[base_name].name}'"
                      f" is empty -- skipping")
                skipped += 1
                continue
            conversation.append({
                "text": text_content,
                "audio_path": str(audio_path.resolve()),
                "speaker": speaker_id,
            })

        if conversation:
            all_conversations.append(conversation)
            total_samples += len(conversation)
            if skipped:
                print(f"[convert] {item.name}: {skipped} audio file(s) had "
                      f"no usable transcript and were left out")
        total_skipped += skipped

    print(f"\n[convert] scanned {processed_dirs} conversation folder(s)")
    if total_skipped:
        print(f"[convert] {total_skipped} audio file(s) left out overall "
              f"(no transcript / unreadable)")
    if not all_conversations:
        print("[convert] WARNING: nothing usable found -- writing an empty "
              "dataset")
    else:
        print(f"[convert] kept {len(all_conversations)} conversation(s), "
              f"{total_samples} utterance(s)")

    output_json.parent.mkdir(parents=True, exist_ok=True)
    with open(output_json, "w", encoding="utf-8") as f:
        json.dump(all_conversations, f, indent=4, ensure_ascii=False)
    print(f"[convert] wrote {output_json}")

"""Corpus preprocessing CLI — rebuilds the reference's prepro scripts
(SURVEY.md §2 "Corpus prep") as one entry point.

Counterpart of `controllable_xgating_tpu/cli/prepro.py`, with every flag;
features go to `<out>/features/` as `.npy` files (no HDF5), which is
what the port's train, eval and caption CLIs read.

Input formats:
  --captions captions.json   {"video_id": ["caption", ...], ...}
  --splits splits.json       {"train": [...], "val": [...], "test": [...]}
plus the aligned feature directory (written separately with
`data/features.py::write_feature_dir`).

`--fixtures` generates the synthetic MSR-VTT-shaped corpus instead (the
offline stand-in for the real downloads; SURVEY.md §7 step 1). Pure host
code: nothing runs on the card.

Usage:
  python -m controllable_xgating_torch.cli.prepro --out data/msrvtt \
      --captions caps.json --splits splits.json
  python -m controllable_xgating_torch.cli.prepro --out data/fixture --fixtures
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--captions")
    p.add_argument("--splits")
    p.add_argument("--min_word_freq", type=int, default=2)
    p.add_argument("--max_caption_len", type=int, default=28)
    p.add_argument("--seqs_per_video", type=int, default=20)
    p.add_argument("--tagger", choices=("rules", "perceptron"),
                   default="rules",
                   help="POS tagger: built-in rule tagger, or a trained "
                        "averaged-perceptron model (see "
                        "controllable_xgating_torch/tools/train_tagger.py)")
    p.add_argument("--tagger_model",
                   help="model path (required with --tagger perceptron)")
    p.add_argument("--vocab_from",
                   help="adopt an existing corpus's word vocabulary (path "
                        "to its info.json) instead of building one — use "
                        "when the new corpus will be scored by checkpoints "
                        "trained on that corpus (ids must match); "
                        "out-of-vocab words encode as UNK")
    p.add_argument("--fixtures", action="store_true")
    p.add_argument("--fixture_videos", type=int, default=200)
    p.add_argument("--fixture_frames", type=int, default=26)
    p.add_argument("--fixture_app_dim", type=int, default=1536)
    p.add_argument("--fixture_motion_dim", type=int, default=1024)
    p.add_argument("--fixture_feature_map",
                   choices=("linear", "entangled", "syntax"),
                   default="linear",
                   help="feature<-scene generative map: 'linear' (v1, "
                        "additive) or 'entangled' (v2 — cross-modal group "
                        "coding + multiplicative modulation; the corpus "
                        "that gives cross gating real work, see "
                        "data/fixtures.py)")
    p.add_argument("--fixture_corrupt_prob", type=float, default=0.0,
                   help="with --fixture_feature_map entangled: fraction of "
                        "videos whose appearance stream shows a distractor "
                        "scene (beacon-flagged in motion)")
    p.add_argument("--fixture_train_frac", type=float, default=0.7)
    p.add_argument("--fixture_val_frac", type=float, default=0.15)
    p.add_argument("--fixture_seed", type=int, default=0)
    p.add_argument("--fixture_bank_seed", type=int, default=None,
                   help="seed for the concept-embedding banks (the "
                        "feature<-scene map) separately from video "
                        "sampling; default: --fixture_seed. To mint a "
                        "held-out corpus an EXISTING checkpoint can read, "
                        "keep the original corpus's bank seed and vary "
                        "only --fixture_seed")
    p.add_argument("--fixture_msvd_videos", type=int, default=0,
                   help="with --fixtures: add this many MSVD-shaped videos "
                        "(variable clip lengths, 'msvdN' ids) to the "
                        "MSR-VTT-shaped part — the joint corpus of BASELINE "
                        "config 5")
    args = p.parse_args(argv)

    if args.fixtures:
        if args.fixture_msvd_videos > 0 and args.fixture_feature_map != "linear":
            p.error("--fixture_feature_map entangled is single-domain only "
                    "(no --fixture_msvd_videos)")
        if args.fixture_msvd_videos > 0 and args.vocab_from:
            p.error("--vocab_from is not supported for the joint "
                    "(--fixture_msvd_videos) corpus")
        if args.fixture_msvd_videos > 0:
            from controllable_xgating_torch.data.fixtures import (
                make_joint_fixture_corpus,
            )

            info = make_joint_fixture_corpus(
                args.out,
                num_msrvtt=args.fixture_videos,
                num_msvd=args.fixture_msvd_videos,
                num_frames=args.fixture_frames,
                app_dim=args.fixture_app_dim,
                motion_dim=args.fixture_motion_dim,
                max_caption_len=args.max_caption_len,
                seqs_per_video=args.seqs_per_video,
            )
        else:
            from controllable_xgating_torch.data.fixtures import (
                make_fixture_corpus,
            )

            info = make_fixture_corpus(
                args.out,
                num_videos=args.fixture_videos,
                num_frames=args.fixture_frames,
                app_dim=args.fixture_app_dim,
                motion_dim=args.fixture_motion_dim,
                max_caption_len=args.max_caption_len,
                seqs_per_video=args.seqs_per_video,
                seed=args.fixture_seed,
                train_frac=args.fixture_train_frac,
                val_frac=args.fixture_val_frac,
                feature_map=args.fixture_feature_map,
                corrupt_prob=args.fixture_corrupt_prob,
                vocab_from=args.vocab_from,
                bank_seed=args.fixture_bank_seed,
            )
    else:
        from controllable_xgating_torch.data.corpus import preprocess_corpus

        if not args.captions or not args.splits:
            p.error("--captions and --splits required (or use --fixtures)")
        with open(args.captions) as f:
            captions = json.load(f)
        with open(args.splits) as f:
            splits = json.load(f)
        tagger = None
        if args.tagger == "perceptron":
            if not args.tagger_model:
                p.error("--tagger perceptron requires --tagger_model")
            from controllable_xgating_torch.data.postag_perceptron import (
                PerceptronTagger,
            )

            tagger = PerceptronTagger.load(args.tagger_model)
        vocab = None
        if args.vocab_from:
            from controllable_xgating_torch.data.corpus import CorpusInfo

            vocab = CorpusInfo.load(args.vocab_from).vocab
        info = preprocess_corpus(
            captions,
            splits,
            args.out,
            min_word_freq=args.min_word_freq,
            max_caption_len=args.max_caption_len,
            seqs_per_video=args.seqs_per_video,
            tagger=tagger,
            vocab=vocab,
        )
    print(
        json.dumps(
            {
                "out": args.out,
                "vocab_size": len(info.vocab),
                "pos_vocab_size": len(info.pos_vocab),
                "videos": len(info.video_ids),
                "splits": {k: len(v) for k, v in info.splits.items()},
            }
        )
    )


if __name__ == "__main__":
    main()

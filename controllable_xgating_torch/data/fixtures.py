"""Synthetic MSR-VTT-shaped fixture corpus + features.

Counterpart of `controllable_xgating_tpu/data/fixtures.py`: the same
scenes, captions, concept banks, splits, sidecar and labels from the same
seeds, with the features written by `write_feature_dir` into
`<out_dir>/features/{app,motion,nframes}.npy` instead of `features.h5`
(tests/test_torch_fixtures.py holds the arrays bit for bit equal).

SURVEY.md §7 step 1: real MSR-VTT/MSVD data (features + caption jsons) is a
download the reference assumes and this offline environment cannot perform,
so all training/eval/bench paths run against this generator. It produces a
corpus with the same *shape* as MSR-VTT (pre-extracted appearance/motion
features, ~N captions per video, train/val/test splits) and — crucially —
a learnable mapping: features are deterministic functions of the latent
scene (subject/action/object/place) each video depicts, so XE training can
drive loss down and metrics are meaningful.

Scenes are rendered to captions through several paraphrase templates, giving
each video a multi-reference ground-truth set like the real corpus (needed
by SCST's CIDEr reward and by multi-reference eval metrics).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from controllable_xgating_torch.data.corpus import CorpusInfo, preprocess_corpus
from controllable_xgating_torch.data.features import FEATURES_DIR, write_feature_dir

SUBJECTS = [
    ("a man", "the man", "a guy"),
    ("a woman", "the woman", "a lady"),
    ("a boy", "the boy", "a young boy"),
    ("a girl", "the girl", "a young girl"),
    ("a dog", "the dog", "a small dog"),
    ("a cat", "the cat", "a black cat"),
    ("two men", "the two men", "a pair of men"),
    ("a group of people", "some people", "several people"),
    ("a chef", "the chef", "a cook"),
    ("a singer", "the singer", "a performer"),
]

# (continuous form, simple-present 3sg form, object); object may be "".
ACTIONS = [
    ("is playing", "plays", "guitar"),
    ("is playing", "plays", "football"),
    ("is riding", "rides", "a horse"),
    ("is riding", "rides", "a bike"),
    ("is cooking", "cooks", "food"),
    ("is cutting", "cuts", "vegetables"),
    ("is singing", "sings", "a song"),
    ("is dancing", "dances", ""),
    ("is running", "runs", ""),
    ("is swimming", "swims", ""),
    ("is driving", "drives", "a car"),
    ("is eating", "eats", "food"),
    ("is talking", "talks", ""),
    ("is drawing", "draws", "a picture"),
    ("is washing", "washes", "a car"),
    ("is climbing", "climbs", "a wall"),
]

ADJECTIVES = ["young", "old", "small", "happy"]

PLACES = [
    "on stage",
    "in the park",
    "in a kitchen",
    "on the street",
    "in a room",
    "on the beach",
    "in the water",
    "on the road",
    "",
]


@dataclass
class Scene:
    subject: int
    action: int
    place: int
    style: int = 0  # v3 ("syntax" map): 0=progressive, 1=simple-present


def _render_captions(scene: Scene, rng: np.random.Generator, n: int) -> list[str]:
    """Several SYNTACTIC variants per scene — the multi-reference set spans
    different POS patterns of the same content, which is what makes the POS
    guidance (and its user control) learnable on this stand-in corpus:

      0: "a man is playing guitar on stage"     DT NN VBZ VBG NN ...
      1: "a man plays guitar"                   DT NN VBZ NN
      2: "there is a man playing guitar ..."    EX VBZ DT NN VBG NN ...
      3: "a young man is playing guitar"        DT JJ NN VBZ VBG NN
    """
    subj_forms = SUBJECTS[scene.subject]
    verb_ing, verb_3sg, obj = ACTIONS[scene.action]
    place = PLACES[scene.place]
    caps = []
    for k in range(n):
        subj = subj_forms[int(rng.integers(len(subj_forms)))]
        variant = k % 4
        if variant == 0:
            parts = [subj, verb_ing] + ([obj] if obj else [])
            if place:
                parts.append(place)
        elif variant == 1:
            parts = [subj, verb_3sg] + ([obj] if obj else [])
        elif variant == 2:
            parts = ["there is", subj, verb_ing.split()[-1]]
            if obj:
                parts.append(obj)
            if place:
                parts.append(place)
        else:
            adj = ADJECTIVES[int(rng.integers(len(ADJECTIVES)))]
            article, _, noun = subj.partition(" ")
            subj_adj = (
                f"{article} {adj} {noun}" if noun else f"{adj} {subj}"
            )
            parts = [subj_adj, verb_ing] + ([obj] if obj else [])
        caps.append(" ".join(parts) + ".")
    return caps


STYLE_NAMES = ("progressive", "simple")


def _render_captions_v3(
    scene: Scene, rng: np.random.Generator, n: int
) -> list[str]:
    """Corpus v3 ("syntax" map): every reference realizes the scene in the
    video's latent STYLE, so the correct caption is syntax-dependent —
    the situation arXiv:1908.10072 §3.2-3.3 claims POS guidance helps
    with. On v1/v2 fixtures the references MIX syntactic variants
    (_render_captions), so any realization scores and psi can only cost;
    here the style decides which 2-4-grams exist in the reference set:

      style 0 (progressive):   "a man is playing guitar on stage"
                               "there is a man playing guitar on stage"
      style 1 (simple-present, place fronted):
                               "on stage a man plays guitar"

    A style-0 caption of a style-1 video shares unigrams but loses the
    higher-order matches ("man plays", "plays guitar", fronted place
    bigrams), which idf-weighted CIDEr punishes hard. Within-style
    lexical variety (subject surface forms, optional adjectives) keeps
    reference entropy for the n-best/diversity studies."""
    subj_forms = SUBJECTS[scene.subject]
    verb_ing, verb_3sg, obj = ACTIONS[scene.action]
    place = PLACES[scene.place]
    caps = []
    for k in range(n):
        subj = subj_forms[int(rng.integers(len(subj_forms)))]
        if rng.random() < 0.3:
            article, _, noun = subj.partition(" ")
            adj = ADJECTIVES[int(rng.integers(len(ADJECTIVES)))]
            subj = f"{article} {adj} {noun}" if noun else f"{adj} {subj}"
        if scene.style == 0:
            if k % 3 == 2:
                parts = ["there is", subj, verb_ing.split()[-1]]
            else:
                parts = [subj, verb_ing]
            if obj:
                parts.append(obj)
            if place:
                parts.append(place)
        else:
            parts = ([place] if place else []) + [subj, verb_3sg]
            if obj:
                parts.append(obj)
        caps.append(" ".join(parts) + ".")
    return caps


N_GROUPS = 4  # appearance channel groups for the v2 "entangled" feature map


def _concept_embeddings_v2(app_dim: int, motion_dim: int, seed: int) -> dict:
    """Concept banks for the v2 ("entangled") feature map.

    Corpus v2 exists because v1's feature->scene map is linear + isotropic
    noise, so a concat + linear projection is a sufficient statistic and the
    cross-gating architecture has no work to do (docs/RESULTS.md, "fourth
    corner"). v2 builds the exact situation the paper's cross gating models
    (arXiv:1908.10072 §3.1): per-stream reliability and content that is only
    decodable through cross-modal interaction. Three ingredients:

    1. MULTIPLICATIVE interaction: the subject embedding in appearance is
       elementwise-modulated by an action-dependent pattern (``mod``).
    2. CONTENT SPLIT ACROSS STREAMS: appearance is divided into N_GROUPS
       channel groups; the TRUE subject occupies group ``action % N_GROUPS``
       while the other groups hold per-video distractor subjects of equal
       amplitude. Decoding the subject therefore requires the action — which
       lives in the MOTION stream. A motion-conditioned sigmoid gate over
       appearance channels (exactly ``ga = sigmoid(em@Uga)`` in
       ops/xgate.py) can select the true group; a fixed linear mix (concat
       ablation) sums true + distractor subjects.
    3. STREAM CORRUPTION with a cross-stream reliability signal: with prob
       ``corrupt_prob`` a video's appearance shows a DISTRACTOR scene, and
       the motion stream carries a beacon direction plus weak redundant
       copies of subject/place — so a model that gates appearance off on
       beacon videos keeps captioning correctly, while an ungated mix
       ingests the distractor content. Only appearance is ever corrupted:
       motion is the reliability *reporter* and the group-selection key, so
       corrupting it would lower the ceiling for every architecture without
       differentiating them.
    """
    rng = np.random.default_rng(seed + 2)  # distinct bank from v1's seed+1
    gdim = app_dim // N_GROUPS

    def bank(n, d):
        return rng.normal(size=(n, d)).astype(np.float32)

    return {
        "subj_app": bank(len(SUBJECTS), gdim),
        "mod": rng.uniform(0.6, 1.4, size=(len(ACTIONS), gdim)).astype(
            np.float32
        ),
        "act_app": bank(len(ACTIONS), app_dim),
        "place_app": bank(len(PLACES), app_dim),
        "act_mot": bank(len(ACTIONS), motion_dim),
        "subj_mot": bank(len(SUBJECTS), motion_dim),
        "place_mot": bank(len(PLACES), motion_dim),
        "beacon_mot": bank(1, motion_dim)[0],
    }


def _concept_embeddings_v3(app_dim: int, motion_dim: int, seed: int) -> dict:
    """v3 ("syntax") banks: v2's entangled map + a style direction in the
    MOTION stream (+style_mot for progressive, -style_mot for simple).

    The style is deliberately a PLAIN additive, single-stream direction —
    decodable by every architecture in the 2x2 grid — so the grid isolates
    the PAPER'S psi mechanism (an explicit supervised syntax pathway vs
    learning realization implicitly from word-level XE) from the
    cross-modal decoding question corpus v2 already adjudicated."""
    embs = _concept_embeddings_v2(app_dim, motion_dim, seed)
    rng = np.random.default_rng(seed + 3)
    embs["style_mot"] = rng.normal(size=(motion_dim,)).astype(np.float32)
    return embs


def _scene_content_v2(
    sc: Scene, embs: dict, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """One scene's clean (noise-free) [app_dim], [motion_dim] content."""
    gdim = embs["subj_app"].shape[1]
    app_dim = embs["act_app"].shape[1]
    app = 0.3 * embs["act_app"][sc.action].copy()  # weak action copy
    if PLACES[sc.place]:
        app += 0.5 * embs["place_app"][sc.place]
    g_true = sc.action % N_GROUPS
    for g in range(N_GROUPS):
        lo, hi = g * gdim, (g + 1) * gdim
        if g == g_true:
            app[lo:hi] += embs["subj_app"][sc.subject] * embs["mod"][sc.action]
        else:
            d = int(rng.integers(len(SUBJECTS) - 1))
            d += d >= sc.subject  # distractor subject != true subject
            app[lo:hi] += embs["subj_app"][d]
    assert N_GROUPS * gdim <= app_dim
    mot = embs["act_mot"][sc.action] + 0.35 * embs["subj_mot"][sc.subject]
    if PLACES[sc.place]:
        mot += 0.25 * embs["place_mot"][sc.place]
    return app, mot


def _render_features_v2(
    scenes: list[Scene],
    nframes: np.ndarray,
    num_frames: int,
    embs: dict,
    rng: np.random.Generator,
    corrupt_prob: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """v2 per-video [T, D] features + per-video corrupted flags; pad frames
    stay zero.

    Corruption draws an independent distractor scene for the appearance
    stream and raises the motion beacon; caption ground truth stays the TRUE
    scene's (recoverable from motion's weak copies)."""
    app_dim = embs["act_app"].shape[1]
    motion_dim = embs["act_mot"].shape[1]
    app = np.zeros((len(scenes), num_frames, app_dim), np.float32)
    motion = np.zeros((len(scenes), num_frames, motion_dim), np.float32)
    corrupted = np.zeros((len(scenes),), bool)
    for i, sc in enumerate(scenes):
        base_app, base_mot = _scene_content_v2(sc, embs, rng)
        if rng.random() < corrupt_prob:
            corrupted[i] = True
            distractor = Scene(
                subject=int(rng.integers(len(SUBJECTS))),
                action=int(rng.integers(len(ACTIONS))),
                place=int(rng.integers(len(PLACES))),
            )
            base_app, _ = _scene_content_v2(distractor, embs, rng)
            base_mot = base_mot + 1.5 * embs["beacon_mot"]
        if "style_mot" in embs:  # v3: style rides the (never-corrupted)
            # motion stream, so corrupted videos keep their true style
            sign = 1.0 if sc.style == 0 else -1.0
            base_mot = base_mot + 0.6 * sign * embs["style_mot"]
        n = int(nframes[i])
        app[i, :n] = base_app[None, :] + 0.1 * rng.normal(
            size=(n, app_dim)
        ).astype(np.float32)
        motion[i, :n] = base_mot[None, :] + 0.1 * rng.normal(
            size=(n, motion_dim)
        ).astype(np.float32)
    return app, motion, corrupted


def _concept_embeddings(app_dim: int, motion_dim: int, seed: int) -> dict:
    """Deterministic concept->feature banks shared by all fixture parts.

    Appearance sees subject+object+place, motion sees the verb — mirroring
    what IRv2 (frames) vs I3D/C3D (clips) would encode. Joint corpora must
    share one bank (one real feature extractor serves both datasets)."""
    emb_rng = np.random.default_rng(seed + 1)
    return {
        "subj": emb_rng.normal(size=(len(SUBJECTS), app_dim)).astype(np.float32),
        "place": emb_rng.normal(size=(len(PLACES), app_dim)).astype(np.float32),
        "act_app": emb_rng.normal(size=(len(ACTIONS), app_dim)).astype(np.float32),
        "act_mot": emb_rng.normal(size=(len(ACTIONS), motion_dim)).astype(np.float32),
    }


def _render_features(
    scenes: list[Scene],
    nframes: np.ndarray,
    num_frames: int,
    embs: dict,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-video [T, D] features from latent scenes; pad frames stay zero."""
    app_dim = embs["subj"].shape[1]
    motion_dim = embs["act_mot"].shape[1]
    app = np.zeros((len(scenes), num_frames, app_dim), np.float32)
    motion = np.zeros((len(scenes), num_frames, motion_dim), np.float32)
    for i, sc in enumerate(scenes):
        base_app = embs["subj"][sc.subject] + 0.7 * embs["act_app"][sc.action]
        if PLACES[sc.place]:
            base_app = base_app + 0.5 * embs["place"][sc.place]
        base_mot = embs["act_mot"][sc.action]
        n = int(nframes[i])
        app[i, :n] = base_app[None, :] + 0.1 * rng.normal(
            size=(n, app_dim)
        ).astype(np.float32)
        motion[i, :n] = base_mot[None, :] + 0.1 * rng.normal(
            size=(n, motion_dim)
        ).astype(np.float32)
    return app, motion


def make_fixture_corpus(
    out_dir: str,
    num_videos: int = 120,
    num_frames: int = 26,
    app_dim: int = 1536,
    motion_dim: int = 1024,
    caps_per_video: int = 5,
    seqs_per_video: int = 20,
    max_caption_len: int = 28,
    seed: int = 0,
    train_frac: float = 0.7,
    val_frac: float = 0.15,
    variable_frames: bool = True,
    feature_map: str = "linear",
    corrupt_prob: float = 0.0,
    vocab_from: str | None = None,
    bank_seed: int | None = None,
) -> CorpusInfo:
    """Generate features/ + info.json + labels.npz + fixture_meta.json
    under out_dir.

    `variable_frames=True` gives each video a random true length in
    [num_frames//2, num_frames] with zero-padded tails + stored `nframes`
    counts (MSVD-like variable clips), so frame masks are exercised by
    default through the whole pipeline.

    `feature_map` selects the feature<-scene generative map: "linear" (v1,
    additive concept embeddings — a concat+linear readout is sufficient) or
    "entangled" (v2 — cross-modally entangled group coding + multiplicative
    modulation; see `_concept_embeddings_v2`). `corrupt_prob` (v2 only)
    corrupts that fraction of videos' appearance streams with distractor
    scenes, beacon-flagged in motion.

    `vocab_from` adopts an existing corpus's vocabulary (path to its
    info.json) instead of building one, so checkpoints trained on that
    corpus can be evaluated on this one — e.g. minting a larger test split
    for better-powered significance tests on an already-trained model.

    `bank_seed` (default: `seed`) seeds the concept-embedding banks — the
    feature<-scene map itself — SEPARATELY from video/caption sampling.
    A held-out corpus for an already-trained checkpoint must keep the
    original corpus's bank_seed and vary only `seed`: changing the bank
    seed re-draws the map, making trained models' features unreadable
    garbage (a mistake this split exists to prevent; the minted
    fixture_meta.json records a `bank_fingerprint` so two corpora can be
    checked for map compatibility before cross-evaluating)."""
    if feature_map not in ("linear", "entangled", "syntax"):
        raise ValueError(f"unknown feature_map {feature_map!r}")
    if corrupt_prob and feature_map == "linear":
        raise ValueError(
            "corrupt_prob requires feature_map='entangled'/'syntax'")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    scenes = [
        Scene(
            subject=int(rng.integers(len(SUBJECTS))),
            action=int(rng.integers(len(ACTIONS))),
            place=int(rng.integers(len(PLACES))),
            style=int(rng.integers(2)) if feature_map == "syntax" else 0,
        )
        for _ in range(num_videos)
    ]

    if variable_frames and num_frames >= 2:
        nframes = rng.integers(
            max(num_frames // 2, 1), num_frames + 1, num_videos
        ).astype(np.int32)
    else:
        nframes = np.full((num_videos,), num_frames, np.int32)
    # temporal jitter so frames differ but stay on-manifold; frames past
    # the video's true length stay zero (pad)
    bank = seed if bank_seed is None else bank_seed
    if feature_map in ("entangled", "syntax"):
        make_banks = (_concept_embeddings_v3 if feature_map == "syntax"
                      else _concept_embeddings_v2)
        embs = make_banks(app_dim, motion_dim, bank)
        app, motion, corrupted = _render_features_v2(
            scenes, nframes, num_frames, embs, rng, corrupt_prob
        )
    else:
        embs = _concept_embeddings(app_dim, motion_dim, bank)
        app, motion = _render_features(scenes, nframes, num_frames, embs, rng)
        corrupted = np.zeros((num_videos,), bool)
    fingerprint = hashlib.sha256()
    for key in sorted(embs):
        fingerprint.update(key.encode())
        fingerprint.update(np.ascontiguousarray(embs[key]).tobytes())
    captions: dict[str, list[str]] = {}
    video_ids = [f"video{i}" for i in range(num_videos)]
    render = (_render_captions_v3 if feature_map == "syntax"
              else _render_captions)
    for i, sc in enumerate(scenes):
        captions[video_ids[i]] = render(sc, rng, caps_per_video)

    write_feature_dir(os.path.join(out_dir, FEATURES_DIR), app, motion, nframes)

    n_train = int(num_videos * train_frac)
    n_val = int(num_videos * val_frac)
    splits = {
        "train": video_ids[:n_train],
        "val": video_ids[n_train : n_train + n_val],
        "test": video_ids[n_train + n_val :],
    }
    # generator-debug sidecar (NOT consumed by training/eval): the latent
    # scene + corruption flag per video, for analyses like the ablation
    # grid's corrupted-vs-clean breakdown (tools/ablation_report.py)
    with open(os.path.join(out_dir, "fixture_meta.json"), "w") as f:
        json.dump(
            {
                "feature_map": feature_map,
                "corrupt_prob": corrupt_prob,
                "bank_seed": bank,
                "bank_fingerprint": fingerprint.hexdigest(),
                "videos": {
                    video_ids[i]: {
                        "subject": scenes[i].subject,
                        "action": scenes[i].action,
                        "place": scenes[i].place,
                        "corrupted": bool(corrupted[i]),
                        **({"style": scenes[i].style}
                           if feature_map == "syntax" else {}),
                    }
                    for i in range(num_videos)
                },
            },
            f,
        )
    vocab = None
    if vocab_from is not None:
        vocab = CorpusInfo.load(vocab_from).vocab
    return preprocess_corpus(
        captions,
        splits,
        out_dir,
        min_word_freq=1,
        max_caption_len=max_caption_len,
        seqs_per_video=seqs_per_video,
        vocab=vocab,
    )


def make_joint_fixture_corpus(
    out_dir: str,
    num_msrvtt: int = 600,
    num_msvd: int = 300,
    num_frames: int = 26,
    app_dim: int = 1536,
    motion_dim: int = 1024,
    caps_msrvtt: int = 5,
    caps_msvd: int = 8,
    seqs_per_video: int = 8,
    max_caption_len: int = 20,
    seed: int = 0,
    train_frac: float = 0.7,
    val_frac: float = 0.15,
) -> CorpusInfo:
    """Joint two-domain corpus for BASELINE config 5 ("MSVD+MSR-VTT joint
    corpus", scaled variant).

    Two parts with the real datasets' distinguishing length/reference
    statistics, one shared feature space and ONE vocab/POS-vocab/df-table:

      * `videoN` ids — MSR-VTT-shaped: every clip exactly `num_frames`
        uniform frames (fixed-length), `caps_msrvtt` references;
      * `msvdN` ids — MSVD-shaped: variable clip lengths in
        [num_frames//3, num_frames] with true `nframes` recorded (pad
        frames masked downstream), more references per video
        (`caps_msvd`, MSVD averages ~2x MSR-VTT's).

    Splits are stratified per part so train/val/test each mix domains.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    num_videos = num_msrvtt + num_msvd
    scenes = [
        Scene(
            subject=int(rng.integers(len(SUBJECTS))),
            action=int(rng.integers(len(ACTIONS))),
            place=int(rng.integers(len(PLACES))),
        )
        for _ in range(num_videos)
    ]
    embs = _concept_embeddings(app_dim, motion_dim, seed)

    nframes = np.full((num_videos,), num_frames, np.int32)
    if num_frames >= 3:
        nframes[num_msrvtt:] = rng.integers(
            max(num_frames // 3, 1), num_frames + 1, num_msvd
        ).astype(np.int32)
    app, motion = _render_features(scenes, nframes, num_frames, embs, rng)

    video_ids = [f"video{i}" for i in range(num_msrvtt)] + [
        f"msvd{i}" for i in range(num_msvd)
    ]
    captions: dict[str, list[str]] = {}
    for i, sc in enumerate(scenes):
        n_caps = caps_msrvtt if i < num_msrvtt else caps_msvd
        captions[video_ids[i]] = _render_captions(sc, rng, n_caps)

    splits = {"train": [], "val": [], "test": []}
    for part in (video_ids[:num_msrvtt], video_ids[num_msrvtt:]):
        n_train = int(len(part) * train_frac)
        n_val = int(len(part) * val_frac)
        splits["train"] += part[:n_train]
        splits["val"] += part[n_train : n_train + n_val]
        splits["test"] += part[n_train + n_val :]

    # feature rows must follow info.json's video order, which
    # preprocess_corpus defines as train+val+test concatenation — permute
    # the generation-order arrays to match (the stratified splits
    # interleave the two parts, so the orders differ here, unlike the
    # single-domain fixture's contiguous slices).
    gen_index = {vid: i for i, vid in enumerate(video_ids)}
    ordered = splits["train"] + splits["val"] + splits["test"]
    perm = np.asarray([gen_index[vid] for vid in ordered])
    write_feature_dir(os.path.join(out_dir, FEATURES_DIR), app[perm], motion[perm],
                      nframes[perm])
    return preprocess_corpus(
        captions,
        splits,
        out_dir,
        min_word_freq=1,
        max_caption_len=max_caption_len,
        seqs_per_video=seqs_per_video,
    )

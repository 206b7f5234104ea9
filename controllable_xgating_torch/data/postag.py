"""Part-of-speech tagger for caption corpora, pure Python.

The port's own copy of the JAX package's module of the same name (the port
imports nothing of that package); tests/test_torch_postag.py holds the two
taggers equal on every caption of the fixture corpora.

Rebuilds the reference's offline POS-tagging step (SURVEY.md §2 "Corpus
prep"): the reference runs NLTK/Stanford `pos_tag` over every training
caption to build a POS vocab and per-caption tag sequences, which the POS
generator stage (paper §3.2) learns to predict. NLTK's tagger models cannot
be downloaded in this offline environment, so this is a self-contained
lexicon + suffix + context tagger emitting Penn Treebank tags.

Design: three passes, in the spirit of Brill tagging —
  1. closed-class lexicon lookup (determiners, prepositions, pronouns, ...),
  2. morphological suffix rules for open-class words,
  3. contextual patch rules (e.g. after a determiner, a "verb-looking" word
     is really a noun: "a building" -> DT NN, not DT VBG).

Caption language (simple present-tense descriptions of videos) is a narrow
register this covers well; divergence from NLTK on general text is expected
and documented. The POS vocab produced is the standard Penn tagset subset.
"""

from __future__ import annotations

# Penn tags emitted by this tagger (the POS generator's vocabulary base).
PENN_TAGS = (
    "CC", "CD", "DT", "EX", "IN", "JJ", "JJR", "JJS", "MD",
    "NN", "NNS", "NNP", "PDT", "POS", "PRP", "PRP$", "RB", "RBR",
    "RBS", "RP", "TO", "UH", "VB", "VBD", "VBG", "VBN", "VBP",
    "VBZ", "WDT", "WP", "WRB",
)

_LEXICON: dict[str, str] = {}


def _add(tag: str, *words: str) -> None:
    for w in words:
        _LEXICON[w] = tag


_add("DT", "a", "an", "the", "this", "that", "these", "those", "some", "any",
     "each", "every", "no", "another", "both", "all")
_add("IN", "in", "on", "at", "by", "with", "from", "into", "onto", "over",
     "under", "about", "around", "through", "between", "against", "during",
     "near", "behind", "beside", "above", "below", "across", "of", "for",
     "as", "off", "inside", "outside", "within", "without", "along", "down",
     "up", "while", "after", "before", "because", "if", "than", "toward",
     "towards", "upon", "beneath", "among", "amongst", "via", "like")
_add("CC", "and", "or", "but", "nor", "yet", "so", "plus")
_add("TO", "to")
_add("PRP", "i", "you", "he", "she", "it", "we", "they", "him", "her",
     "them", "me", "us", "himself", "herself", "itself", "themselves",
     "someone", "something", "everyone", "everything", "anyone", "nobody")
_add("PRP$", "my", "your", "his", "its", "our", "their", "hers", "theirs")
_add("WDT", "which", "whatever", "whichever")
_add("WP", "who", "whom", "what", "whoever")
_add("WRB", "how", "when", "where", "why")
_add("EX", "there")
_add("MD", "can", "could", "will", "would", "shall", "should", "may",
     "might", "must")
_add("VBZ", "is", "has", "does", "'s")
_add("VBP", "are", "have", "do", "am", "'re", "'ve")
_add("VBD", "was", "were", "did", "had", "'d")
_add("VB", "be")
_add("VBG", "being", "having", "doing", "going", "playing", "talking",
     "walking", "running", "singing", "dancing", "cooking", "riding",
     "driving", "swimming", "eating", "speaking", "showing", "wearing",
     "holding", "standing", "sitting", "watching", "looking", "moving",
     "using", "making", "trying", "getting", "putting", "cutting", "mixing")
_add("VBN", "been", "done", "made", "seen", "shown", "given", "taken",
     "dressed", "covered", "filled", "parked", "placed", "worn")
_add("RB", "not", "n't", "very", "quickly", "slowly", "here", "also",
     "then", "now", "again", "away", "back", "together", "fast", "well",
     "just", "really", "almost", "out")
_add("RP", "apart")
_add("CD", "one", "two", "three", "four", "five", "six", "seven", "eight",
     "nine", "ten", "eleven", "twelve", "several", "few", "many")
_add("JJ", "young", "old", "small", "large", "big", "little", "red",
     "blue", "green", "yellow", "black", "white", "brown", "orange",
     "purple", "pink", "gray", "grey", "long", "short", "high", "low",
     "open", "other", "different", "same", "new", "beautiful", "empty",
     "full", "front", "left", "right", "male", "female", "wooden", "3d")
_add("JJR", "better", "bigger", "smaller", "larger", "older", "younger",
     "faster", "slower", "more", "less")
_add("JJS", "best", "biggest", "smallest", "largest", "most", "least")
_add("UH", "oh", "wow", "hey", "yes", "yeah")
_add("NN", "man", "woman", "person", "boy", "girl", "lady", "guy", "kid",
     "child", "dog", "cat", "car", "video", "water", "food", "music",
     "room", "road", "street", "field", "stage", "ball", "game", "group",
     "people", "men", "women", "children", "kids")

# plural irregulars that don't end in s
_PLURAL_NO_S = {"people", "men", "women", "children", "kids", "feet", "teeth"}

_ING_NOUNS = {"building", "clothing", "morning", "evening", "painting",
              "ceiling", "wedding", "string", "ring", "king", "thing",
              "something", "nothing", "everything", "anything", "spring",
              "wing", "swing"}

_ED_ADJS = {"red", "tired", "excited", "interested", "colored", "crowded",
            "bed", "speed", "seed"}


def _suffix_tag(word: str) -> str:
    """Morphology-based guess for words not in the lexicon."""
    if word.replace(".", "").replace(",", "").isdigit():
        return "CD"
    if word.endswith("ing") and len(word) > 4 and word not in _ING_NOUNS:
        return "VBG"
    if word.endswith("ed") and len(word) > 3 and word not in _ED_ADJS:
        return "VBD"
    if word.endswith("ly") and len(word) > 3:
        return "RB"
    if word.endswith(("ous", "ful", "ive", "ible", "able", "ish", "less",
                      "ic", "al")) and len(word) > 4:
        return "JJ"
    if word.endswith("est") and len(word) > 4:
        return "JJS"
    if word.endswith("er") and len(word) > 3:
        # talker/runner vs bigger — nouns more common in captions (player,
        # singer, dancer); tag agentive -er as NN.
        return "NN"
    if word.endswith("s") and not word.endswith(("ss", "us", "is")) and len(word) > 2:
        return "NNS"
    if word in _PLURAL_NO_S:
        return "NNS"
    return "NN"


class PennTagger:
    """Lexicon + suffix + context POS tagger over PTB-tokenized words."""

    def __init__(self, extra_lexicon: dict[str, str] | None = None):
        self.lexicon = dict(_LEXICON)
        if extra_lexicon:
            self.lexicon.update(extra_lexicon)

    def tag(self, tokens: list[str]) -> list[str]:
        tags = []
        for tok in tokens:
            low = tok.lower()
            tag = self.lexicon.get(low)
            if tag is None:
                tag = _suffix_tag(low)
            tags.append(tag)

        # Contextual patch rules (Brill-style).
        for i, (tok, tag) in enumerate(zip(tokens, tags)):
            prev = tags[i - 1] if i > 0 else None
            nxt = tags[i + 1] if i + 1 < len(tags) else None
            # DT/JJ/PRP$ + VBD-looking word followed by end/IN/NN -> noun
            # ("a bed", "the speed") handled by _ED_ADJS; generic rule:
            if prev in ("DT", "PRP$", "JJ", "CD") and tag in ("VBD", "VB", "VBP"):
                # "a man *walks*" is VBZ-covered; DT + bare-verb-looking is
                # usually a noun in captions ("a drink", "the show").
                tags[i] = "NN"
            # determiner + VBG + noun -> adjective-like participle stays VBG
            # (PTB tags "a running man" VBG) — no change needed.
            # noun + bare 3sg verb ending in s was tagged NNS; if previous is
            # NN/PRP ("a man walks") retag NNS->VBZ when followed by
            # DT/IN/RB/end and the singular form looks verbal.
            if (
                tag == "NNS"
                and prev in ("NN", "NNP", "PRP", "NNS")
                and (nxt in ("DT", "IN", "TO", "RB", "PRP$", "VBG", None) or nxt == "CD")
                and tok.lower() not in _PLURAL_NO_S
            ):
                tags[i] = "VBZ"
            # "to" + verb-looking noun -> VB ("to play")
            if prev == "TO" and tag in ("NN", "VBZ", "VBD"):
                tags[i] = "VB"
            # modal + anything verbal-looking -> VB
            if prev == "MD" and tag in ("NN", "VBZ", "VBP", "VBD"):
                tags[i] = "VB"
        return tags


_DEFAULT = PennTagger()


def tag_tokens(tokens: list[str]) -> list[str]:
    return _DEFAULT.tag(tokens)

# Verbatim copy of scoreperformer_tpu/data/musicxml_directions.py; the port imports nothing of the JAX package.
"""MusicXML performance-direction parsing.

Counterpart of scoreperformer/data/directions/* (parser.py, dynamic.py,
tempo.py, words.py, articulation.py). The reference depends on the external
`musicxml_parser` package; this environment has none, so a minimal MusicXML
reader built on xml.etree extracts exactly what direction parsing needs:
per-part directions with xml positions (divisions-based time bookkeeping with
<backup>/<forward>/<chord>/<grace> handling), note articulations, and measure
positions for the anacrusis shift.

Output schema matches the reference: dicts of
{type: 'dynamic/f' | 'tempo/allegro' | 'articulation/staccato' | 'words/...',
 start, end, part, staff[, pitch]}.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

# ---- keyword tables (dynamic.py / tempo.py / articulation.py) ----

DYNAMIC_PREFIX = "dynamic"
ABS_DYNAMIC_KEYS = [
    "pppp", "ppp", "pp",
    ("p", "piano"),
    "mp", "mf",
    ("f", "forte"),
    "ff", "fff", "ffff",
    "fp", "ffp",
]
REL_DYNAMIC_KEYS = [
    ("crescendo", "cresc"),
    ("diminuendo", "dim", "decresc"),
    ("sf", "fz", "sfz", "sffz"),
    ("rf", "rfz"),
]
DYNAMIC_KEYS = ABS_DYNAMIC_KEYS + REL_DYNAMIC_KEYS

TEMPO_PREFIX = "tempo"
ABS_TEMPO_KEYS = [
    "grave", "largo", "larghetto", "lento",
    "adagio", "andante", "andantino", "moderato",
    "allegretto", "allegro", "vivace",
    "presto", "prestissimo",
]
REL_TEMPO_KEYS = [
    ("accelerando", "acc", "accel"),
    ("ritardando", "rit", "ritard"),
    ("rallentando", "rall"),
    ("stringendo", "string"),
    "calando", "più mosso", "animato", "stretto", "smorzando", "ritenuto",
]
RET_TEMPO_KEYS = [("tempo primo", "tempo i"), "a tempo"]
TEMPO_KEYS = ABS_TEMPO_KEYS + REL_TEMPO_KEYS + RET_TEMPO_KEYS

ARTICULATION_PREFIX = "articulation"
ARTICULATION_KEYS = ["arpeggiate", "fermata", "staccato", "tenuto"]

PUNCTUATION = [",", ".", "\n", "(", ")"]


def word_regularization(word: Optional[str]) -> Optional[str]:
    """(words.py:6-14)"""
    if not word:
        return None
    for symbol in PUNCTUATION:
        word = word.replace(symbol, " ")
    word = word.replace("  ", " ")
    return word.strip().lower()


def extract_main_keyword(key):
    return key[0] if isinstance(key, tuple) else key


def extract_direction_by_keys(dir_word, keywords):
    for key in keywords:
        if isinstance(key, tuple) and dir_word in key:
            return key[0]
        elif dir_word == key:
            return key
    return None


def hairpin_word_regularization(word):
    """(dynamic.py:23-29)"""
    if word is None:
        return word
    if "decresc" in word:
        return "diminuendo"
    if "cresc" in word:
        return "crescendo"
    if "dim" in word:
        return "diminuendo"
    return word


def build_prefixed_keys(keys, prefix):
    return [f"{prefix}/" + extract_main_keyword(k) for k in keys]


DYNAMIC_DIRECTION_KEYS = build_prefixed_keys(DYNAMIC_KEYS, DYNAMIC_PREFIX)
TEMPO_DIRECTION_KEYS = build_prefixed_keys(TEMPO_KEYS, TEMPO_PREFIX)
ARTICULATION_DIRECTION_KEYS = build_prefixed_keys(ARTICULATION_KEYS, ARTICULATION_PREFIX)


# ---- minimal MusicXML document model ----


@dataclass
class XmlDirection:
    kind: str  # 'dynamic' | 'crescendo' | 'diminuendo' | 'words' | 'none'
    content: str
    xml_position: int
    staff: Optional[int] = None
    number: Optional[int] = None
    measure: int = 0


@dataclass
class XmlNote:
    xml_position: int
    duration: int
    pitch: Optional[str]
    staff: Optional[int]
    is_arpeggiate: bool = False
    is_fermata: bool = False
    is_staccato: bool = False
    is_tenuto: bool = False
    is_rest: bool = False
    is_grace: bool = False


@dataclass
class XmlPart:
    directions: List[XmlDirection] = field(default_factory=list)
    notes: List[XmlNote] = field(default_factory=list)
    measure_positions: List[int] = field(default_factory=list)
    max_position: int = 0


DYNAMIC_TAGS = [
    "pppp", "ppp", "pp", "p", "mp", "mf", "f", "ff", "fff", "ffff",
    "fp", "ffp", "sf", "sfz", "sffz", "fz", "rf", "rfz",
]


def _parse_part(part_el) -> XmlPart:
    part = XmlPart()
    position = 0
    divisions = 1

    for measure_idx, measure in enumerate(part_el.findall("measure")):
        part.measure_positions.append(position)
        measure_start = position
        prev_note_pos = position

        for el in measure:
            tag = el.tag
            if tag == "attributes":
                div = el.find("divisions")
                if div is not None and div.text:
                    divisions = int(div.text)
            elif tag == "backup":
                d = el.find("duration")
                if d is not None and d.text:
                    position -= int(d.text)
            elif tag == "forward":
                d = el.find("duration")
                if d is not None and d.text:
                    position += int(d.text)
            elif tag == "direction":
                staff_el = el.find("staff")
                staff = int(staff_el.text) if staff_el is not None and staff_el.text else None
                for dtype in el.findall("direction-type"):
                    for child in dtype:
                        if child.tag == "dynamics":
                            marks = [c.tag for c in child]
                            content = marks[0] if marks else ""
                            part.directions.append(
                                XmlDirection("dynamic", content, position, staff, None, measure_idx)
                            )
                        elif child.tag == "wedge":
                            wtype = child.get("type", "")
                            number = int(child.get("number", "1"))
                            if wtype in ("crescendo", "diminuendo"):
                                part.directions.append(
                                    XmlDirection(wtype, "start", position, staff, number, measure_idx)
                                )
                            elif wtype == "stop":
                                part.directions.append(
                                    XmlDirection("none", "stop", position, staff, number, measure_idx)
                                )
                        elif child.tag == "words":
                            part.directions.append(
                                XmlDirection(
                                    "words", child.text or "", position, staff, None, measure_idx
                                )
                            )
            elif tag == "note":
                is_chord = el.find("chord") is not None
                is_grace = el.find("grace") is not None
                is_rest = el.find("rest") is not None
                dur_el = el.find("duration")
                duration = int(dur_el.text) if dur_el is not None and dur_el.text else 0

                note_pos = prev_note_pos if is_chord else position

                pitch_el = el.find("pitch")
                pitch = None
                if pitch_el is not None:
                    step = pitch_el.findtext("step", "")
                    octave = pitch_el.findtext("octave", "")
                    alter = pitch_el.findtext("alter")
                    acc = {"1": "#", "-1": "b"}.get(alter, "") if alter else ""
                    pitch = f"{step}{acc}{octave}"

                staff_el = el.find("staff")
                staff = int(staff_el.text) if staff_el is not None and staff_el.text else None

                notations = el.find("notations")
                note = XmlNote(
                    xml_position=note_pos,
                    duration=duration,
                    pitch=pitch,
                    staff=staff,
                    is_rest=is_rest,
                    is_grace=is_grace,
                )
                if notations is not None:
                    art = notations.find("articulations")
                    note.is_staccato = art is not None and art.find("staccato") is not None
                    note.is_tenuto = art is not None and art.find("tenuto") is not None
                    note.is_fermata = notations.find("fermata") is not None
                    note.is_arpeggiate = notations.find("arpeggiate") is not None
                if not is_rest:
                    part.notes.append(note)

                if not is_chord and not is_grace:
                    prev_note_pos = position
                    position += duration
                part.max_position = max(part.max_position, note_pos + duration)

        position = max(position, measure_start)
        part.max_position = max(part.max_position, position)

    return part


def read_musicxml(path_or_str: Union[str, bytes]) -> List[XmlPart]:
    """Parse a .musicxml/.xml file (or .mxl zip) into per-part structures."""
    if isinstance(path_or_str, (bytes,)):
        root = ET.fromstring(path_or_str)
    elif isinstance(path_or_str, str) and path_or_str.lstrip().startswith("<"):
        root = ET.fromstring(path_or_str)
    elif str(path_or_str).endswith(".mxl"):
        with zipfile.ZipFile(path_or_str) as zf:
            names = [n for n in zf.namelist() if n.endswith(".xml") and not n.startswith("META-INF")]
            root = ET.fromstring(zf.read(names[0]))
    else:
        root = ET.parse(path_or_str).getroot()

    return [_parse_part(p) for p in root.findall("part")]


# ---- direction parsing (parser.py:48-173) ----


def _clean_part_directions(directions: List[XmlDirection]) -> List[XmlDirection]:
    """Resolve 'none' wedge stops to their opening hairpin type
    (parser.py:20-45)."""
    directions = sorted(directions, key=lambda d: d.xml_position)
    cleaned = []
    for i, d in enumerate(directions):
        if d.kind == "none":
            for j in range(i):
                prev = directions[i - j - 1]
                if prev.number is None:
                    continue
                if prev.number == d.number:
                    if prev.kind == "crescendo":
                        d.kind = "crescendo"
                        break
                    elif prev.kind == "diminuendo":
                        d.kind = "diminuendo"
                        break
        cleaned.append(d)
    return cleaned


def parse_directions(
    parts: Union[List[XmlPart], str],
    delete_unmatched: bool = False,
    delete_duplicates: bool = False,
    ticks_scale: float = 1.0,
) -> List[List[dict]]:
    """MusicXML parts → per-part lists of direction dicts (parser.py:48-173)."""
    if isinstance(parts, (str, bytes)):
        parts = read_musicxml(parts)

    max_xml_position = max((p.max_position for p in parts), default=0)

    # anacrusis shift (parser.py:55-57)
    mp = parts[0].measure_positions if parts else []
    xml_shift = max(0, mp[2] - 2 * mp[1] + mp[0]) if len(mp) >= 3 else 0

    score_directions = []
    for part_idx, part in enumerate(parts):
        active_dynamic = None
        active_tempo = None
        active_hairpins: Dict[str, XmlDirection] = {}
        part_directions: List[dict] = []

        for d in _clean_part_directions(part.directions):
            d_dict = None
            if d.kind == "dynamic":
                d_dict = {
                    "type": "dynamic",
                    "start": d.xml_position,
                    "end": max_xml_position,
                }
                abs_dyn = extract_direction_by_keys(d.content, ABS_DYNAMIC_KEYS)
                rel_dyn = extract_direction_by_keys(d.content, REL_DYNAMIC_KEYS)
                if abs_dyn is not None:
                    d_dict["type"] += "/" + abs_dyn
                    if active_dynamic is not None:
                        active_dynamic["end"] = d.xml_position
                    active_dynamic = d_dict
                elif rel_dyn is not None:
                    d_dict["type"] += "/" + rel_dyn
                    d_dict["end"] = d_dict["start"]
                else:
                    continue
            elif d.kind in ("crescendo", "diminuendo"):
                key = f"{d.kind}_{d.number}"
                if d.content == "start":
                    active_hairpins[key] = d
                    continue
                elif d.content == "stop":
                    start_d = active_hairpins.pop(key, None)
                    if not start_d:
                        continue
                    d_dict = {
                        "type": "dynamic/" + d.kind,
                        "start": start_d.xml_position,
                        "end": d.xml_position,
                    }
            elif d.kind == "words":
                word = word_regularization(d.content)
                word = hairpin_word_regularization(word)
                tempo_word = extract_direction_by_keys(word, TEMPO_KEYS)

                if word in ("crescendo", "diminuendo"):
                    d_dict = {"type": DYNAMIC_PREFIX}
                elif tempo_word is not None:
                    word = tempo_word
                    d_dict = {"type": TEMPO_PREFIX}
                    if active_tempo is not None:
                        active_tempo["end"] = d.xml_position
                    active_tempo = d_dict
                elif delete_unmatched:
                    continue
                else:
                    d_dict = {"type": "words"}

                d_dict["type"] += "/" + (word or "")
                d_dict.update(
                    start=d.xml_position,
                    end=max_xml_position if d_dict["type"].startswith("tempo") else d.xml_position,
                )
            else:
                d_dict = None

            if d_dict is not None:
                d_dict.update(part=part_idx, staff=int(d.staff) if d.staff is not None else 1)
                part_directions.append(d_dict)

        # note articulations (parser.py:132-151)
        for note in part.notes:
            if note.is_grace:
                continue
            for flag, name in (
                (note.is_arpeggiate, "arpeggiate"),
                (note.is_fermata, "fermata"),
                (note.is_staccato, "staccato"),
                (note.is_tenuto, "tenuto"),
            ):
                if flag:
                    part_directions.append(
                        {
                            "type": ARTICULATION_PREFIX + "/" + name,
                            "start": note.xml_position,
                            "end": note.xml_position + note.duration,
                            "pitch": note.pitch,
                            "part": part_idx,
                            "staff": int(note.staff) if note.staff is not None else 1,
                        }
                    )

        if xml_shift != 0 or ticks_scale != 1.0:
            for d_dict in part_directions:
                d_dict["start"] = int(ticks_scale * (d_dict["start"] + xml_shift))
                d_dict["end"] = int(ticks_scale * (d_dict["end"] + xml_shift))

        part_directions = sorted(part_directions, key=lambda d: (d["start"], d["type"], d["end"]))

        if delete_duplicates:
            i = 0
            while i < len(part_directions) - 1:
                a, b = part_directions[i], part_directions[i + 1]
                if a["type"] == b["type"] and a["start"] == b["start"]:
                    del part_directions[i + 1]
                    continue
                i += 1

        score_directions.append(part_directions)

    return score_directions

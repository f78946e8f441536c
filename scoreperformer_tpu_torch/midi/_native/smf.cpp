// Verbatim copy of scoreperformer_tpu/midi/_native/smf.cpp; the port imports nothing of the JAX package.
// Native SMF (Standard MIDI File) parser.
//
// The host-side counterpart of scoreperformer_tpu/midi/smf.py::read_midi —
// exact same event semantics (running status, FIFO note pairing, velocity-0
// note-offs, per-MTrk (channel, program, is_drum) note grouping, tempo /
// time-signature / key-signature / marker meta events, sysex + aftertouch
// skipping) implemented in C++ for the dataset-preparation and data-loading
// hot path, exposed through a minimal C ABI consumed via ctypes
// (scoreperformer_tpu/midi/native.py). No third-party dependencies.
//
// Reference behavior being reproduced (for parity tests): the framework's own
// Python parser, which in turn mirrors what the reference stack got from
// miditoolkit (reference scoreperformer/data/midi/containers.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <string>
#include <tuple>
#include <vector>

namespace {

struct Note {
  int32_t pitch;
  int32_t velocity;
  int64_t start;
  int64_t end;
};

struct Group {
  int32_t channel;
  int32_t program;
  int32_t is_drum;
  std::string name;
  std::vector<Note> notes;
  // shared per-MTrk event lists are duplicated per group (parity with the
  // Python parser, which attaches the same arrays to every group track)
  std::vector<int64_t> ccs;  // (tick, number, value) rows, flattened
  std::vector<int64_t> pbs;  // (tick, value) rows, flattened
};

struct KeySig {
  int64_t tick;
  std::string name;
};

struct Marker {
  int64_t tick;
  std::string text;
};

struct Result {
  int32_t division = 0;
  std::vector<Group> groups;
  std::vector<int64_t> tempo_ticks;
  std::vector<double> tempo_bpm;
  std::vector<int64_t> ts_ticks;
  std::vector<int32_t> ts_num;
  std::vector<int32_t> ts_den;
  std::vector<KeySig> keysigs;
  std::vector<Marker> markers;
  std::string error;
};

const char* kMajorKeys[] = {"C", "G", "D", "A", "E", "B", "F#", "C#"};
const char* kFlatKeys[] = {"C", "F", "Bb", "Eb", "Ab", "Db", "Gb", "Cb"};

bool read_varlen(const uint8_t* d, size_t len, size_t& p, uint64_t& value) {
  value = 0;
  for (int i = 0; i < 8; ++i) {
    if (p >= len) return false;
    uint8_t byte = d[p++];
    value = (value << 7) | (byte & 0x7F);
    if (!(byte & 0x80)) return true;
  }
  return false;  // varlen too long
}

uint32_t be32(const uint8_t* d) {
  return (uint32_t(d[0]) << 24) | (uint32_t(d[1]) << 16) | (uint32_t(d[2]) << 8) | d[3];
}
uint16_t be16(const uint8_t* d) { return (uint16_t(d[0]) << 8) | d[1]; }

bool parse(const uint8_t* data, size_t len, Result& res) {
  if (len < 14 || std::memcmp(data, "MThd", 4) != 0) {
    res.error = "not a MIDI file (missing MThd)";
    return false;
  }
  uint32_t header_len = be32(data + 4);
  uint16_t ntracks = be16(data + 10);
  uint16_t division = be16(data + 12);
  if (division & 0x8000) {
    res.error = "SMPTE time division is not supported";
    return false;
  }
  res.division = division;
  size_t pos = 8 + header_len;

  for (uint16_t t = 0; t < ntracks; ++t) {
    if (pos + 8 > len) break;
    uint32_t length = be32(data + pos + 4);
    if (std::memcmp(data + pos, "MTrk", 4) != 0) {
      pos += 8 + size_t(length);
      continue;
    }
    size_t end = pos + 8 + size_t(length);
    if (end > len) end = len;
    size_t p = pos + 8;
    int64_t tick = 0;
    uint8_t running_status = 0;
    std::string track_name;
    std::map<int, int> channel_programs;
    // (channel, pitch) -> FIFO of (start_tick, velocity, program)
    std::map<std::pair<int, int>, std::deque<std::tuple<int64_t, int, int>>> open_notes;
    // (channel, program, is_drum) -> notes
    std::map<std::tuple<int, int, int>, std::vector<Note>> notes_by_key;
    std::vector<int64_t> ccs;
    std::vector<int64_t> pbs;

    auto close_note = [&](int channel, int pitch, int64_t end_tick) {
      auto it = open_notes.find({channel, pitch});
      if (it != open_notes.end() && !it->second.empty()) {
        auto [start_tick, velocity, program] = it->second.front();
        it->second.pop_front();
        notes_by_key[{channel, program, channel == 9 ? 1 : 0}].push_back(
            {pitch, velocity, start_tick, end_tick});
      }
    };

    while (p < end) {
      uint64_t delta;
      if (!read_varlen(data, end, p, delta)) break;
      // clamp: varlen deltas reach 2^56, so unclamped accumulation over many
      // events could overflow int64 (UB); 2^62 keeps every later sum in range
      tick += int64_t(delta);
      if (tick > (int64_t(1) << 62)) tick = int64_t(1) << 62;
      if (p >= end) break;
      uint8_t status = data[p];
      if (status & 0x80) {
        ++p;
        if (status < 0xF0) running_status = status;
      } else {
        status = running_status;
        if (!(status & 0x80)) {
          res.error = "dangling data byte with no running status";
          return false;
        }
      }

      uint8_t kind = status & 0xF0;
      int channel = status & 0x0F;
      if (kind == 0x90) {  // note on
        if (p + 2 > end) break;
        int pitch = data[p], velocity = data[p + 1];
        p += 2;
        if (velocity > 0) {
          int program = 0;
          auto it = channel_programs.find(channel);
          if (it != channel_programs.end()) program = it->second;
          open_notes[{channel, pitch}].push_back({tick, velocity, program});
        } else {
          close_note(channel, pitch, tick);
        }
      } else if (kind == 0x80) {  // note off
        if (p + 2 > end) break;
        close_note(channel, data[p], tick);
        p += 2;
      } else if (kind == 0xB0) {  // control change
        if (p + 2 > end) break;
        ccs.push_back(tick);
        ccs.push_back(data[p]);
        ccs.push_back(data[p + 1]);
        p += 2;
      } else if (kind == 0xC0) {  // program change
        if (p + 1 > end) break;
        channel_programs[channel] = data[p];
        p += 1;
      } else if (kind == 0xE0) {  // pitch bend
        if (p + 2 > end) break;
        pbs.push_back(tick);
        pbs.push_back(int64_t((int(data[p + 1]) << 7 | data[p]) - 8192));
        p += 2;
      } else if (kind == 0xA0) {  // poly aftertouch
        p += 2;
      } else if (kind == 0xD0) {  // channel aftertouch
        p += 1;
      } else if (status == 0xFF) {  // meta
        if (p >= end) break;
        uint8_t meta_type = data[p++];
        uint64_t meta_len;
        if (!read_varlen(data, end, p, meta_len)) break;
        if (p + meta_len > end) meta_len = end - p;
        const uint8_t* payload = data + p;
        p += meta_len;
        if (meta_type == 0x51 && meta_len == 3) {  // tempo
          uint32_t uspq = (uint32_t(payload[0]) << 16) | (uint32_t(payload[1]) << 8) | payload[2];
          if (uspq > 0) {
            res.tempo_ticks.push_back(tick);
            res.tempo_bpm.push_back(60000000.0 / double(uspq));
          }
        } else if (meta_type == 0x58 && meta_len >= 2) {  // time signature
          res.ts_ticks.push_back(tick);
          res.ts_num.push_back(payload[0]);
          // clamp the denominator power: valid files use <=6, and an
          // unclamped shift by >=31 is undefined behavior on int32
          res.ts_den.push_back(1 << (payload[1] > 30 ? 30 : payload[1]));
        } else if (meta_type == 0x59 && meta_len >= 2) {  // key signature
          int sf = int(int8_t(payload[0]));
          int minor = meta_len > 1 ? payload[1] : 0;
          const char** names = sf < 0 ? kFlatKeys : kMajorKeys;
          int idx = sf < 0 ? -sf : sf;
          if (idx > 7) idx = 7;
          std::string name = names[idx];
          if (minor) name += "m";
          res.keysigs.push_back({tick, name});
        } else if (meta_type == 0x06) {  // marker
          res.markers.push_back({tick, std::string((const char*)payload, meta_len)});
        } else if (meta_type == 0x03) {  // track name
          track_name = std::string((const char*)payload, meta_len);
        } else if (meta_type == 0x2F) {  // end of track
          break;
        }
      } else if (status == 0xF0 || status == 0xF7) {  // sysex
        uint64_t sys_len;
        if (!read_varlen(data, end, p, sys_len)) break;
        p += sys_len;
      } else {
        res.error = "unexpected MIDI status byte";
        return false;
      }
    }

    // close dangling notes at end of track (FIFO order)
    for (auto& [key, queue] : open_notes) {
      for (auto& [start_tick, velocity, program] : queue) {
        notes_by_key[{key.first, program, key.first == 9 ? 1 : 0}].push_back(
            {key.second, velocity, start_tick, tick});
      }
    }

    for (auto& [key, notes] : notes_by_key) {  // std::map iterates sorted
      std::stable_sort(notes.begin(), notes.end(), [](const Note& a, const Note& b) {
        return std::tie(a.start, a.pitch, a.end) < std::tie(b.start, b.pitch, b.end);
      });
      Group g;
      g.channel = std::get<0>(key);
      g.program = std::get<1>(key);
      g.is_drum = std::get<2>(key);
      g.name = track_name;
      g.notes = std::move(notes);
      g.ccs = ccs;
      g.pbs = pbs;
      res.groups.push_back(std::move(g));
    }
    pos = end;
  }

  // sort tempo / timesig / keysig / marker lists by tick (stable)
  {
    std::vector<size_t> idx(res.tempo_ticks.size());
    for (size_t i = 0; i < idx.size(); ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](size_t a, size_t b) {
      return res.tempo_ticks[a] < res.tempo_ticks[b];
    });
    std::vector<int64_t> tt;
    std::vector<double> tb;
    for (size_t i : idx) {
      tt.push_back(res.tempo_ticks[i]);
      tb.push_back(res.tempo_bpm[i]);
    }
    res.tempo_ticks = std::move(tt);
    res.tempo_bpm = std::move(tb);
  }
  {
    std::vector<size_t> idx(res.ts_ticks.size());
    for (size_t i = 0; i < idx.size(); ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](size_t a, size_t b) {
      return res.ts_ticks[a] < res.ts_ticks[b];
    });
    std::vector<int64_t> t;
    std::vector<int32_t> n, d;
    for (size_t i : idx) {
      t.push_back(res.ts_ticks[i]);
      n.push_back(res.ts_num[i]);
      d.push_back(res.ts_den[i]);
    }
    res.ts_ticks = std::move(t);
    res.ts_num = std::move(n);
    res.ts_den = std::move(d);
  }
  std::stable_sort(res.keysigs.begin(), res.keysigs.end(),
                   [](const KeySig& a, const KeySig& b) {
                     return std::tie(a.tick, a.name) < std::tie(b.tick, b.name);
                   });
  std::stable_sort(res.markers.begin(), res.markers.end(),
                   [](const Marker& a, const Marker& b) { return a.tick < b.tick; });
  return true;
}

}  // namespace

extern "C" {

void* smf_parse(const uint8_t* data, size_t len, char* err, size_t errcap) {
  Result* res = new Result();
  if (!parse(data, len, *res)) {
    if (err && errcap > 0) {
      std::strncpy(err, res->error.c_str(), errcap - 1);
      err[errcap - 1] = '\0';
    }
    delete res;
    return nullptr;
  }
  return res;
}

void smf_free(void* h) { delete static_cast<Result*>(h); }

int32_t smf_division(void* h) { return static_cast<Result*>(h)->division; }

int32_t smf_group_count(void* h) {
  return int32_t(static_cast<Result*>(h)->groups.size());
}

void smf_group_info(void* h, int32_t i, int32_t* program, int32_t* is_drum,
                    int64_t* note_count, int64_t* cc_count, int64_t* pb_count) {
  const Group& g = static_cast<Result*>(h)->groups[i];
  *program = g.program;
  *is_drum = g.is_drum;
  *note_count = int64_t(g.notes.size());
  *cc_count = int64_t(g.ccs.size() / 3);
  *pb_count = int64_t(g.pbs.size() / 2);
}

const char* smf_group_name(void* h, int32_t i) {
  return static_cast<Result*>(h)->groups[i].name.c_str();
}

void smf_group_notes(void* h, int32_t i, int32_t* pitch, int32_t* velocity,
                     int64_t* start, int64_t* end) {
  const Group& g = static_cast<Result*>(h)->groups[i];
  for (size_t j = 0; j < g.notes.size(); ++j) {
    pitch[j] = g.notes[j].pitch;
    velocity[j] = g.notes[j].velocity;
    start[j] = g.notes[j].start;
    end[j] = g.notes[j].end;
  }
}

void smf_group_ccs(void* h, int32_t i, int64_t* out) {
  const Group& g = static_cast<Result*>(h)->groups[i];
  std::memcpy(out, g.ccs.data(), g.ccs.size() * sizeof(int64_t));
}

void smf_group_pbs(void* h, int32_t i, int64_t* out) {
  const Group& g = static_cast<Result*>(h)->groups[i];
  std::memcpy(out, g.pbs.data(), g.pbs.size() * sizeof(int64_t));
}

int64_t smf_tempo_count(void* h) {
  return int64_t(static_cast<Result*>(h)->tempo_ticks.size());
}

void smf_tempos(void* h, int64_t* ticks, double* bpm) {
  const Result* r = static_cast<Result*>(h);
  std::memcpy(ticks, r->tempo_ticks.data(), r->tempo_ticks.size() * sizeof(int64_t));
  std::memcpy(bpm, r->tempo_bpm.data(), r->tempo_bpm.size() * sizeof(double));
}

int64_t smf_timesig_count(void* h) {
  return int64_t(static_cast<Result*>(h)->ts_ticks.size());
}

void smf_timesigs(void* h, int64_t* ticks, int32_t* num, int32_t* den) {
  const Result* r = static_cast<Result*>(h);
  std::memcpy(ticks, r->ts_ticks.data(), r->ts_ticks.size() * sizeof(int64_t));
  std::memcpy(num, r->ts_num.data(), r->ts_num.size() * sizeof(int32_t));
  std::memcpy(den, r->ts_den.data(), r->ts_den.size() * sizeof(int32_t));
}

int64_t smf_keysig_count(void* h) {
  return int64_t(static_cast<Result*>(h)->keysigs.size());
}

const char* smf_keysig(void* h, int64_t i, int64_t* tick) {
  const KeySig& k = static_cast<Result*>(h)->keysigs[i];
  *tick = k.tick;
  return k.name.c_str();
}

int64_t smf_marker_count(void* h) {
  return int64_t(static_cast<Result*>(h)->markers.size());
}

const char* smf_marker(void* h, int64_t i, int64_t* tick, int64_t* textlen) {
  const Marker& m = static_cast<Result*>(h)->markers[i];
  *tick = m.tick;
  *textlen = int64_t(m.text.size());
  return m.text.data();
}

}  // extern "C"

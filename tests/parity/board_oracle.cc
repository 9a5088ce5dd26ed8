// Parity oracle: compiles the REFERENCE board engine (read-only sources at
// /root/reference/cc/game + cc/core, built against the absl shims in this
// directory) into a line-protocol driver, so Python tests can check the JAX
// board (p3achygo_tpu/game/board.py) move-for-move against the original
// implementation (BASELINE.md acceptance criterion: fixed-seed
// move-sequence/score parity).
//
// Protocol (stdin -> stdout, one response block per command):
//   new <komi> <prohibit_pa 0|1>   -> "ok"
//   play <b|w> <flat 0..360|361=pass> -> "status <int>" + 361-char board
//   legal <b|w>                    -> 362 chars of 0/1 (PlayMoveDry status)
//   score                          -> "score <black> <white>" + ownership
//   pa                             -> recompute + 361-char pass-alive map
//   ladders                        -> 361-char laddered-stones map
//   gameover                       -> "gameover 0|1"
//   quit
// Board chars: '.' empty, 'x' black, 'o' white.
#include <cstdio>
#include <iostream>
#include <memory>
#include <sstream>
#include <string>

// Test-only: expose Board::group_tracker_ for the `pa` command (the
// reference keeps the pass-alive map private; this driver never links
// against other TUs including board.h, so the ODR caveat is moot).
#define private public
#include "cc/game/board.h"
#include "cc/game/board_dsl.h"
#undef private

using game::Board;
using game::Color;
using game::Loc;
using game::MoveStatus;

namespace {

constexpr int kLen = BOARD_LEN;

char ColorChar(int c) { return c == BLACK ? 'x' : (c == WHITE ? 'o' : '.'); }

Loc FlatToLoc(int flat) {
  if (flat == kLen * kLen) return game::kPassLoc;
  return Loc{static_cast<int>(flat / kLen), static_cast<int>(flat % kLen)};
}

template <typename ArrayT>
std::string BoardString(const ArrayT& data) {
  std::string s;
  s.reserve(kLen * kLen);
  for (int i = 0; i < kLen * kLen; ++i) s.push_back(ColorChar(data[i]));
  return s;
}

}  // namespace

int main() {
  std::unique_ptr<Board> board = std::make_unique<Board>(false, 7.5f);
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    std::string cmd;
    in >> cmd;
    if (cmd == "quit") break;
    if (cmd == "new") {
      float komi = 7.5f;
      int prohibit_pa = 0;
      in >> komi >> prohibit_pa;
      board = std::make_unique<Board>(prohibit_pa != 0, komi);
      std::cout << "ok\n";
    } else if (cmd == "play") {
      std::string color;
      int flat;
      in >> color >> flat;
      Color c = color == "b" ? BLACK : WHITE;
      MoveStatus st = board->PlayMove(FlatToLoc(flat), c);
      std::cout << "status " << static_cast<int>(st) << "\n"
                << BoardString(board->position()) << "\n";
    } else if (cmd == "legal") {
      std::string color;
      in >> color;
      Color c = color == "b" ? BLACK : WHITE;
      std::string s;
      s.reserve(kLen * kLen + 1);
      for (int i = 0; i < kLen * kLen; ++i) {
        auto res = board->PlayMoveDry(FlatToLoc(i), c);
        s.push_back(res.status == MoveStatus::kValid ? '1' : '0');
      }
      s.push_back('1');  // pass is always legal
      std::cout << s << "\n";
    } else if (cmd == "score") {
      game::Scores scores = board->GetScores();
      std::cout << "score " << scores.black_score << " " << scores.white_score
                << "\n"
                << BoardString(scores.ownership) << "\n";
    } else if (cmd == "pa") {
      board->CalculatePassAliveRegions();
      std::cout << BoardString(board->group_tracker_.pass_alive()) << "\n";
    } else if (cmd == "set") {
      // Load a position from a compact 361-char board string (via the
      // reference's own DSL parser, board_dsl.cc ParseBoardDSL).
      std::string compact;
      in >> compact;
      board = std::make_unique<Board>(game::ParseBoardDSL(compact));
      std::cout << "ok\n";
    } else if (cmd == "ladders") {
      std::cout << BoardString(board->GetLadderedStones()) << "\n";
    } else if (cmd == "gameover") {
      std::cout << "gameover " << (board->IsGameOver() ? 1 : 0) << "\n";
    } else {
      std::cout << "err unknown\n";
    }
    std::cout.flush();
  }
  return 0;
}
